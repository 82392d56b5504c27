"""PyTorch port: every shape the JAX package serves reaches a CUDA kernel
(ROADMAP C1, closed).

`ops.kernels.refusal` is the table of every shape rule the CUDA wrappers
enforce. For a grid of shapes this file calls the JAX package's function
at a tiny size (each call shows the JAX package serves the shape) and
holds the port's table to it:
  * paged attention at head_dim 1-128, and 129, 160, 192, 256;
  * the fused apply (`bias_act`) at C 1-70, float32 and bfloat16;
  * the NHWC average pool at C 1-20;
  * flash attention at d 1-128, and 129, 160, 192, 256, and bh 70000 as a
    shape only;
  * paged and flash attention at d 257, 384 and 512 (128-column slices);
the table takes every one. It refuses only what the JAX package refuses
too: an unknown activation, a pool that does not divide the spatial dims.
The wrappers themselves, given tensors that report a card, pass every
check at such shapes and stop only at the kernel build, which the tests
deny its `nvcc`. The flash routes (tensor cores or CUDA cores) are pinned
by dtype and head dim, the paged routes (split, tensor cores, CUDA cores)
by q dtype, slab dtype, head dim and query rows.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu.ops import pallas_attention as pa

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)

# head dims over 128: a remainder until the capacity-256 instances
WIDE = (129, 160, 192, 256)
# head dims over 256: once the named remainder, now 128-column slices
REMAINDER = (257, 384, 512)


def _rand(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _jax_paged(d):
    """The JAX engine's paged read at head_dim d (2 lanes, 2 queries, 2
    heads, 8 positions)."""
    q = _rand((2, 2, 2, d), d)
    k = _rand((3, 1, 8, 2, d), d + 1)
    v = _rand((3, 1, 8, 2, d), d + 2)
    out = jfused.paged_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 jnp.asarray([0, 5], jnp.int32), 0)
    return np.asarray(out)


def _jax_flash(d, bh=1):
    q, k, v = (_rand((bh, 8, d), d + i) for i in range(3))
    return np.asarray(pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True))


def _served(out, shape):
    assert out.shape == shape and np.isfinite(out).all()


@pytest.mark.parametrize("d", range(1, 129))
def test_paged_head_dims_the_jax_package_serves_reach_a_kernel(d):
    _served(_jax_paged(d), (2, 2, 2, d))
    assert kernels.refusal("paged_attention", head_dim=d) is None


@pytest.mark.parametrize("d", range(1, 129))
def test_flash_head_dims_the_jax_package_serves_reach_a_kernel(d):
    _served(_jax_flash(d), (1, 8, d))
    assert kernels.refusal("flash", d=d) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", range(1, 71))
def test_apply_channel_counts_the_jax_package_serves_reach_a_kernel(c,
                                                                    dtype):
    x = jnp.asarray(_rand((3, c), c)).astype(dtype)
    out = np.asarray(jfused.bias_act(x, jnp.zeros((c,), dtype), "relu")
                     .astype(jnp.float32))
    _served(out, (3, c))
    assert kernels.refusal("scale_shift_act", act="relu", c=c) is None


@pytest.mark.parametrize("c", range(1, 21))
def test_pool_channel_counts_the_jax_package_serves_reach_a_kernel(c):
    out = np.asarray(jfused.avg_pool2d(jnp.asarray(_rand((2, 4, 6, c), c)),
                                       (2, 3)))
    _served(out, (2, 2, 2, c))
    assert kernels.refusal("avg_pool2d", h=4, w=6, ph=2, pw=3, c=c) is None


def test_flash_bh_past_the_old_grid_limit_is_a_shape_the_table_takes():
    """bh 70000 was over grid y's 65535; the grid is now one-dimensional.
    The JAX package serves it (shown at d 1, T 1)."""
    q = jnp.ones((70000, 1, 1), jnp.float32)
    _served(np.asarray(pa.flash_attention(q, q, q)), (70000, 1, 1))
    assert kernels.refusal("flash", d=16, bh=70000) is None


@pytest.mark.parametrize("kernel,key,call", [
    ("paged_attention", "head_dim", _jax_paged),
    ("flash", "d", _jax_flash)])
@pytest.mark.parametrize("d", WIDE)
def test_head_dims_over_128_are_the_named_remainder(kernel, key, call, d):
    """Head dims 129-256, once the named remainder, now reach a kernel:
    the JAX package serves them, and the table takes them (the wrappers'
    side is `test_wrappers_take_the_new_shapes_to_the_kernel_build`)."""
    out = call(d)
    assert out.shape[-1] == d and np.isfinite(out).all()
    assert kernels.refusal(kernel, **{key: d}) is None


@pytest.mark.parametrize("kernel,key,call", [
    ("paged_attention", "head_dim", _jax_paged),
    ("flash", "d", _jax_flash)])
@pytest.mark.parametrize("d", REMAINDER)
def test_head_dims_over_256_are_the_named_remainder(kernel, key, call, d):
    """Head dims over 256, once the named remainder, now reach a kernel
    (128-column slices): the JAX package serves them, and the table takes
    them (the wrappers' side is
    `test_wrappers_take_the_new_shapes_to_the_kernel_build`)."""
    out = call(d)
    assert out.shape[-1] == d and np.isfinite(out).all()
    assert kernels.refusal(kernel, **{key: d}) is None


def test_the_table_names_only_the_remainder_and_refusals_jax_shares():
    """No remainder is left: every row is a refusal the JAX package
    shares, and the paged and flash kernels have none."""
    kinds = {(name, kind) for name, kind, _, _ in kernels.RULES}
    assert {kind for _, kind in kinds} == {"jax"}
    assert {name for name, _ in kinds} == {"scale_shift_act", "avg_pool2d",
                                           "image_augment"}
    assert not hasattr(kernels, "HEAD_DIM_MAX")


def test_the_refusals_jax_shares_are_refused_by_jax_too():
    with pytest.raises(ValueError, match="unsupported fused activation"):
        jfused.bias_act(jnp.ones((2, 4)), jnp.zeros((4,)), "swish")
    assert "swish" in kernels.refusal("scale_shift_act", act="swish", c=4)
    with pytest.raises(ValueError, match="must divide"):
        jfused.avg_pool2d(jnp.ones((1, 5, 4, 3)), (2, 2))
    assert "must divide" in kernels.refusal("avg_pool2d", h=5, w=4, ph=2,
                                            pw=2, c=3)


# ---------------------------------------------------------------------------
# the wrappers call the table and take every other shape to the build
# ---------------------------------------------------------------------------
class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrappers'
    checks can be driven without one."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return t.as_subclass(_CudaLooking)


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_LIBS", {})
    isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: isfile(p) and not str(p).endswith("nvcc"))


def _paged_call(d, dtype=torch.bfloat16, kv=torch.bfloat16, C=1):
    q = _cuda(torch.zeros((2, C, 3, d), dtype=dtype))
    k = _cuda(torch.zeros((3, 1, 8, 3, d), dtype=kv))
    scales = {}
    if kv == torch.int8:
        s = _cuda(torch.ones((3, 1, 8)))
        scales = dict(k_scale=s, v_scale=s)
    return lambda: kernels.paged_attention_cuda(
        q, k, k, _cuda(torch.zeros(2, dtype=torch.int32)), 0, **scales)


def _flash_call(d, bh=2, dtype=torch.bfloat16, kernel="flash_fwd_lse"):
    q = _cuda(torch.zeros((bh, 4, d), dtype=dtype))
    stat = _cuda(torch.zeros((bh, 4, 1)))
    bwd = (q, q, q, q, stat, stat, True, 0.5)
    return {"flash_fwd": lambda: kernels.flash_fwd_cuda(q, q, q, True, 0.5,
                                                        False),
            "flash_fwd_lse": lambda: kernels.flash_fwd_cuda(q, q, q, True,
                                                            0.5, True),
            "flash_bwd_dq": lambda: kernels.flash_bwd_dq_cuda(*bwd),
            "flash_bwd_dkv": lambda: kernels.flash_bwd_dkv_cuda(*bwd)}[kernel]


def _augment_call(dtype, c, crop, mean):
    x = _cuda(torch.zeros((2, 6, 7, c), dtype=getattr(torch, dtype)))
    y0 = _cuda(torch.zeros(2, dtype=torch.int32)) if crop else None
    return lambda: kernels.image_augment_cuda(
        x, y0, y0, None, crop or (6, 7), mean, None, torch.bfloat16)


CALLS = {
    "paged d=16 bf16": _paged_call(16),
    "paged d=24 int8": _paged_call(24, torch.float32, torch.int8),
    "paged d=12 bf16 over f32": _paged_call(12, kv=torch.float32),
    "apply C=10 f32": lambda: kernels.scale_shift_act_cuda(
        _cuda(torch.zeros((4, 10))), None, _cuda(torch.zeros(10)), None,
        "relu"),
    "apply C=4 bf16": lambda: kernels.scale_shift_act_cuda(
        _cuda(torch.zeros((4, 4), dtype=torch.bfloat16)),
        _cuda(torch.ones(4)), _cuda(torch.zeros(4)), None, None),
    "pool C=12 fwd": lambda: kernels.avg_pool2d_fwd_cuda(
        _cuda(torch.zeros((2, 4, 4, 12))), 2, 2),
    "pool C=12 bwd": lambda: kernels.avg_pool2d_bwd_cuda(
        _cuda(torch.zeros((2, 2, 2, 12))), 4, 4, 2, 2),
    "flash d=12 bf16": _flash_call(12),
    "flash d=96 bf16": _flash_call(96),
    "flash d=40 f32": _flash_call(40, dtype=torch.float32),
    "flash bh=70000": _flash_call(16, bh=70000),
    "paged d=136 bf16": _paged_call(136),
    "paged d=256 bf16": _paged_call(256),
    "paged d=256 int8": _paged_call(256, torch.float32, torch.int8),
    **{f"{kernel} d={d} {name}": _flash_call(d, dtype=dtype, kernel=kernel)
       for kernel in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                      "flash_bwd_dkv")
       for d, dtype, name in ((136, torch.bfloat16, "bf16"),
                              (256, torch.float32, "f32"))},
    "flash_bwd_dq d=64 bf16 tensor cores": _flash_call(
        64, kernel="flash_bwd_dq"),
    "flash_bwd_dkv d=64 bf16 tensor cores": _flash_call(
        64, kernel="flash_bwd_dkv"),
    # head dims over 256, refused until the 128-column slices
    "paged d=257 bf16": _paged_call(257),
    "flash d=320 bf16": _flash_call(320),
    "flash_bwd_dkv d=264 bf16": _flash_call(264, kernel="flash_bwd_dkv"),
    **{f"paged d={d} {name}": _paged_call(d, *types)
       for d in (384, 512)
       for name, types in (("bf16", ()), ("int8", (torch.float32, torch.int8)),
                           ("f32 over bf16", (torch.float32,)))},
    **{f"{kernel} d={d} f32": _flash_call(d, dtype=torch.float32,
                                          kernel=kernel)
       for kernel in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                      "flash_bwd_dkv")
       for d in (257, 384, 512)},
    # a chunk of each paged route: tensor cores (bf16 and float16 q, 16-bit
    # and int8 slabs) and CUDA cores (f32 q)
    "paged chunk C=40 bf16 tensor cores": _paged_call(64, C=40),
    "paged chunk C=40 int8 tensor cores": _paged_call(
        64, kv=torch.int8, C=40),
    "paged chunk C=40 f32 cuda cores": _paged_call(64, torch.float32, C=40),
    "paged chunk C=40 f16 tensor cores": _paged_call(
        64, torch.float16, torch.float16, C=40),
    "paged chunk C=40 f16 over int8 tensor cores": _paged_call(
        64, torch.float16, torch.int8, C=40),
    # the augment: every input type, channel count and route
    **{f"augment {dt} C={c} {name}": _augment_call(dt, c, crop, mean)
       for dt in ("uint8", "int8", "bool", "int16", "int32", "float32")
       for c, crop, mean, name in ((3, (4, 5), (0.5,) * 3, "cut"),
                                   (1, None, (0.5,) * 3, "broadcast"),
                                   (4, (4, 5), None, "cut of 4"),
                                   (5, None, (0.5,), "5 channels"))},
    "augment unaligned view": lambda: kernels.image_augment_cuda(
        _cuda(torch.zeros(2 * 6 * 7 * 3 + 1, dtype=torch.uint8)[1:]
              .view(2, 6, 7, 3)), None, None, None, (6, 7), None, None,
        torch.float32),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrappers_take_the_new_shapes_to_the_kernel_build(name, no_nvcc):
    """Every check passes; the call stops where the kernel is built."""
    with pytest.raises(MXNetError, match="nvcc not found"):
        CALLS[name]()


@pytest.mark.parametrize("name,call,match", [
    ("pool", lambda: kernels.avg_pool2d_fwd_cuda(
        _cuda(torch.zeros((1, 5, 4, 3))), 2, 2), "must divide"),
    ("apply", lambda: kernels.scale_shift_act_cuda(
        _cuda(torch.zeros((2, 4))), None, None, None, "swish"),
     "unsupported fused activation"),
    ("augment C=1 cut", _augment_call("uint8", 1, (4, 5), None),
     "reads the first 3 channels"),
    ("augment C=2 mean 3", _augment_call("uint8", 2, None, (0.5,) * 3),
     "do not broadcast"),
    ("augment C=4 cut mean 4", _augment_call("int16", 4, (4, 5), (0.5,) * 4),
     "do not broadcast"),
])
def test_wrappers_refuse_what_the_table_refuses(name, call, match, no_nvcc):
    with pytest.raises(MXNetError, match=match):
        call()


ROUTES = [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 12, "cuda_cores"), (torch.bfloat16, 1, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 96, "cuda_cores"),
    (torch.bfloat16, 136, "cuda_cores"), (torch.bfloat16, 256, "cuda_cores"),
    (torch.float32, 8, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.float32, 256, "cuda_cores")]
# float16: the forward and the backward on the tensor cores where
# bfloat16's are
F16_FWD = [
    (torch.float16, 8, "wgmma"), (torch.float16, 64, "wgmma"),
    (torch.float16, 96, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.float16, 12, "cuda_cores"), (torch.float16, 136, "cuda_cores"),
    (torch.float16, 256, "cuda_cores")]
F16_BWD = list(F16_FWD)


@pytest.mark.parametrize("dtype,d,route", ROUTES + F16_FWD)
def test_flash_forward_route_is_by_dtype_and_head_dim_alone(dtype, d, route):
    assert kernels.flash_fwd_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,route", ROUTES + F16_BWD)
def test_flash_backward_route_is_by_dtype_and_head_dim_alone(dtype, d,
                                                             route):
    """B7 and B8 take the tensor cores where the forward does, for
    bfloat16 and float16 (d % 8 == 0 up to 128)."""
    assert kernels.flash_bwd_route(dtype, d) == route
    assert kernels.flash_bwd_route(dtype, d) == kernels.flash_fwd_route(
        dtype, d)


PAGED_ROUTES = [
    # decode, the speculative verify and short windows: split, any types, d
    (torch.bfloat16, torch.bfloat16, 64, 1, "split"),
    (torch.bfloat16, torch.int8, 64, 4, "split"),
    (torch.float32, torch.float32, 64, 16, "split"),
    (torch.float32, torch.int8, 512, 1, "split"),
    (torch.bfloat16, torch.bfloat16, 12, 9, "split"),
    # chunks of bf16 q over bf16 (d % 8) or int8 (d % 16) up to 128: tensor
    # cores
    (torch.bfloat16, torch.bfloat16, 64, 17, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 64, 256, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 8, 40, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 128, 256, "wgmma"),
    (torch.bfloat16, torch.int8, 64, 256, "wgmma"),
    (torch.bfloat16, torch.int8, 16, 40, "wgmma"),
    (torch.bfloat16, torch.int8, 128, 40, "wgmma"),
    # every other chunk: CUDA cores
    (torch.float32, torch.float32, 64, 256, "cuda_cores"),
    (torch.float32, torch.bfloat16, 64, 256, "cuda_cores"),
    (torch.float32, torch.int8, 64, 256, "cuda_cores"),
    (torch.bfloat16, torch.float32, 64, 256, "cuda_cores"),
    (torch.bfloat16, torch.bfloat16, 12, 40, "cuda_cores"),
    (torch.bfloat16, torch.int8, 24, 40, "cuda_cores"),
    (torch.bfloat16, torch.bfloat16, 136, 256, "cuda_cores"),
    (torch.bfloat16, torch.bfloat16, 256, 256, "cuda_cores"),
    (torch.bfloat16, torch.int8, 384, 40, "cuda_cores"),
    # float16 chunks take the tensor cores where bf16's do: float16 q over a
    # float16 slab (d % 8) or an int8 one (d % 16), d <= 128
    (torch.float16, torch.float16, 8, 40, "wgmma"),
    (torch.float16, torch.float16, 16, 17, "wgmma"),
    (torch.float16, torch.float16, 64, 256, "wgmma"),
    (torch.float16, torch.float16, 128, 256, "wgmma"),
    (torch.float16, torch.int8, 16, 40, "wgmma"),
    (torch.float16, torch.int8, 64, 256, "wgmma"),
    (torch.float16, torch.int8, 128, 40, "wgmma"),
    (torch.float16, torch.float16, 12, 40, "cuda_cores"),
    (torch.float16, torch.float16, 136, 256, "cuda_cores"),
    (torch.float16, torch.int8, 8, 40, "cuda_cores"),
    (torch.float16, torch.int8, 12, 40, "cuda_cores"),
    (torch.float16, torch.int8, 136, 40, "cuda_cores"),
    (torch.float16, torch.float16, 64, 16, "split"),
    (torch.float16, torch.int8, 64, 1, "split"),
    # mixed 16-bit pairs and float32 beside float16: CUDA cores
    (torch.float16, torch.bfloat16, 64, 256, "cuda_cores"),
    (torch.bfloat16, torch.float16, 64, 256, "cuda_cores"),
    (torch.float16, torch.float32, 64, 256, "cuda_cores"),
    (torch.float32, torch.float16, 64, 256, "cuda_cores")]


@pytest.mark.parametrize("q_dtype,kv_dtype,d,C,route", PAGED_ROUTES)
def test_paged_route_is_by_types_head_dim_and_rows_alone(q_dtype, kv_dtype,
                                                         d, C, route):
    assert kernels.paged_route(q_dtype, kv_dtype, d, C) == route


def test_paged_counters_start_at_zero_per_route():
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    for route in ("split", "wgmma", "cuda_cores"):
        assert counts[f"paged_attention_{route}"] == 0


def test_paged_wgmma_route_names_an_unaligned_stride(no_nvcc):
    """The tensor-core route raises on a slab stride a tile load cannot
    take, naming it, and never takes another route."""
    q = _cuda(torch.zeros((2, 40, 3, 64), dtype=torch.bfloat16))
    # positions 193 elements apart (386 bytes), heads and dims contiguous
    k = _cuda(torch.zeros(3 * 8 * 193, dtype=torch.bfloat16).as_strided(
        (3, 1, 8, 3, 64), (8 * 193, 8 * 193, 193, 64, 1)))
    with pytest.raises(MXNetError, match="position stride 193"):
        kernels.paged_attention_cuda(
            q, k, k, _cuda(torch.zeros(2, dtype=torch.int32)), 0)
    assert kernels.launch_counts()["paged_attention_wgmma"] == 0


def test_paged_float16_wgmma_route_names_an_unaligned_stride(no_nvcc):
    """The float16 tensor-core route raises as the bf16 one does, on a slab
    stride (here the row stride) a tile load cannot take, and never takes
    another route."""
    q = _cuda(torch.zeros((2, 40, 3, 64), dtype=torch.float16))
    # rows 1543 elements apart (3086 bytes), positions 192
    k = _cuda(torch.zeros(3 * 1543, dtype=torch.float16).as_strided(
        (3, 1, 8, 3, 64), (1543, 1543, 192, 64, 1)))
    with pytest.raises(MXNetError, match="row stride 1543"):
        kernels.paged_attention_cuda(
            q, k, k, _cuda(torch.zeros(2, dtype=torch.int32)), 0)
    assert kernels.launch_counts()["paged_attention_wgmma"] == 0


def test_library_name_hashes_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """An edit to a shared header renames the libraries of exactly the
    sources that include it, so no stale library survives it."""
    for f in os.listdir(kernels._CSRC):
        with open(os.path.join(kernels._CSRC, f), "rb") as src:
            (tmp_path / f).write_bytes(src.read())
    monkeypatch.setattr(kernels, "_CSRC", str(tmp_path))
    names = {n: kernels._lib_path(n)[1] for n in kernels._SOURCES}
    for header in ("hopper.cuh", "tiles.cuh"):
        path = tmp_path / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        moved = {n for n in names if kernels._lib_path(n)[1] != names[n]}
        assert moved == {"flash_attention", "paged_attention"}, header
        names = {n: kernels._lib_path(n)[1] for n in kernels._SOURCES}


# ---------------------------------------------------------------------------
# the augment: every channel count the JAX package serves, and its routes
# ---------------------------------------------------------------------------
AUGMENT_GRID = [(c, cut, lm)
                for c in range(1, 7) for cut in (False, True)
                for lm in (None, 1, 3, c)]


@pytest.mark.parametrize("c,cut,lm", AUGMENT_GRID,
                         ids=[f"C{c}-{'cut' if cut else 'full'}-m{lm}"
                              for c, cut, lm in AUGMENT_GRID])
def test_augment_channels_the_jax_package_serves_reach_a_kernel(c, cut, lm):
    """The table takes exactly the channel cases the JAX package serves:
    all C read where nothing is cut, the first 3 under a cut, broadcast
    with the mean's length."""
    x = jnp.asarray(np.arange(2 * 5 * 6 * c).reshape(2, 5, 6, c)
                    .astype(np.uint8))
    mean = None if lm is None else tuple(0.1 * (i + 1) for i in range(lm))
    crop = (4, 5) if cut else None
    ch, cw = crop or (5, 6)
    why = kernels.refusal("image_augment", h=5, w=6, ch=ch, cw=cw, c=c,
                          lm=lm, ls=None)
    try:
        out = np.asarray(jfused.image_augment(
            x, np.array([1, 2], np.uint32), mean=mean, crop_hw=crop))
    except (TypeError, ValueError):
        assert why is not None
        return
    assert why is None
    cr, cout = kernels.augment_channels(c, cut, lm)
    assert out.shape == (2, ch, cw, cout) and np.isfinite(out).all()


AUGMENT_ROUTES = [
    (torch.uint8, 3, 3, 224, "table"),
    (torch.int8, 1, 3, 224, "table"),
    (torch.bool, 4, 4, 224, "table"),
    (torch.uint8, 5, 5, 224, "direct"),
    (torch.uint8, 1, 70, 224, "direct"),
    (torch.int16, 3, 3, 224, "direct"),
    (torch.int32, 3, 3, 224, "direct"),
    (torch.float32, 3, 3, 224, "direct"),
    (torch.uint8, 12258, 12258, 1, "direct"),
    (torch.uint8, 12259, 12259, 1, "scalar"),
    (torch.int32, 3064, 3064, 1, "direct"),
    (torch.int32, 3065, 3065, 1, "scalar"),
    (torch.uint8, 1, 3, 2 ** 30, "scalar")]


@pytest.mark.parametrize("dtype,c,cout,cw,route", AUGMENT_ROUTES)
def test_augment_route_is_by_type_channels_and_width(dtype, c, cout, cw,
                                                     route):
    assert kernels.augment_route(dtype, c, cout, cw) == route


def test_augment_counters_start_at_zero_per_route():
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    for route in ("table", "direct", "scalar"):
        assert counts[f"image_augment_{route}"] == 0
