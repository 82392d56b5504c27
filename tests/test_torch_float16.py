"""PyTorch port: float16 on every kernel (ROADMAP C3) and float16 AMP with
dynamic loss scaling, on the CPU.

  * the wrappers take float16 CUDA tensors and launch the kernel the
    route rule names with the one dtype table's code (a stand-in for the
    built library records each launch's arguments: no card or `nvcc`
    here), for the apply (B1), every q/slab pair of paged attention with a
    float16 side (B4; float16 chunks over float16 or int8 on the tensor
    cores where bf16's are) and the four flash kernels (B5-B8 on the tensor
    cores where bf16's are);
  * `kernels.DTYPE_CODES` is the table the C entry points read: each
    source's entry-point comment names the same codes;
  * the plain versions a float16 kernel is held against on the card
    (`fused.bias_act`, `fused.batch_norm`, `attention.flash_attention`,
    `fused.paged_attention`) against the JAX package's ops in float16
    (their Pallas kernels in interpret mode);
  * `amp.init("float16")` and its casts, and `amp.LossScaler` against the
    JAX package's over one sequence of overflows.

Tolerances: a float16 output of a plain version against the JAX op within
one float16 step of its size (2^-10 relative, both sides round an f32 sum
once; gradients, which round more than once, within 2^-8); loss scales
exactly.
"""
import os
import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.amp import lists as jlists
from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu.ops import pallas_attention as pa

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.ops import attention, fused, kernels

from test_torch_coverage import _cuda
from torch_port_utils import jax_amp_restored

torch.set_num_threads(1)

F16 = torch.float16
STEP = 2.0 ** -10


# the leading int arguments of each entry point: the codes, the device,
# the head dim and the lse flag
_LEADING = {"mx_scale_shift_act": 3, "mx_paged_attention_fwd": 4,
            "mx_flash_fwd": 4, "mx_flash_bwd_dq": 3, "mx_flash_bwd_dkv": 3,
            "mx_flash_fwd_wgmma": 4, "mx_flash_bwd_dq_wgmma": 3,
            "mx_flash_bwd_dkv_wgmma": 3}


class _FakeLib:
    """Records each launch (entry point and its leading int arguments) in
    place of the built libraries."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in _LEADING:
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name,) + tuple(args[:_LEADING[name]]))
            return 0
        return launch


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    empty = torch.empty
    # the split route's workspace: on the CPU here
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    monkeypatch.setattr(kernels, "_load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kernels.reset_launch_counts()
    yield lib
    kernels.reset_launch_counts()


def test_apply_wrapper_takes_float16(fake_lib):
    for c, act in ((64, "relu"), (10, None)):
        x = _cuda(torch.zeros((6, c), dtype=F16))
        row = _cuda(torch.zeros(c))
        out = kernels.scale_shift_act_cuda(x, row, row, x, act)
        assert out.dtype == F16
        assert fake_lib.calls[-1] == ("mx_scale_shift_act", 2,
                                      kernels.ACT_CODES[act], 0)
    assert kernels.launch_counts_by_dtype() == {
        ("scale_shift_act", "float16"): 2}


PAIRS = [(q, kv) for q in (torch.float32, torch.bfloat16, F16)
         for kv in (torch.float32, torch.bfloat16, F16, torch.int8)
         if F16 in (q, kv)]


@pytest.mark.parametrize("C", [1, 4, 256])
@pytest.mark.parametrize("q_dtype,kv_dtype", PAIRS,
                         ids=[f"{q}-{kv}".replace("torch.", "")
                              for q, kv in PAIRS])
def test_paged_wrapper_takes_every_float16_pair(q_dtype, kv_dtype, C,
                                                fake_lib):
    q = _cuda(torch.zeros((2, C, 3, 64), dtype=q_dtype))
    k = _cuda(torch.zeros((3, 1, 300, 3, 64), dtype=kv_dtype))
    scales = {}
    if kv_dtype == torch.int8:
        s = _cuda(torch.ones((3, 1, 300)))
        scales = dict(k_scale=s, v_scale=s)
    out = kernels.paged_attention_cuda(
        q, k, k, _cuda(torch.zeros(2, dtype=torch.int32)), 0, **scales)
    assert out.dtype == q_dtype
    route = kernels.paged_route(q_dtype, kv_dtype, 64, C)
    # a float16 chunk takes the tensor cores where bf16's does: float16 q
    # over a float16 or an int8 slab; every other pair the CUDA cores
    tensor_cores = q_dtype == F16 and kv_dtype in (F16, torch.int8)
    assert route == ("split" if C <= 16 else
                     "wgmma" if tensor_cores else "cuda_cores")
    codes = {"split": 0, "wgmma": 1, "cuda_cores": 2}
    assert fake_lib.calls == [("mx_paged_attention_fwd", codes[route],
                               kernels.DTYPE_CODES[q_dtype],
                               kernels.DTYPE_CODES[kv_dtype], 0)]
    counts = kernels.launch_counts()
    assert counts[f"paged_attention_{route}"] == 1
    by = kernels.launch_counts_by_dtype()
    assert by[("paged_attention_q", str(q_dtype)[6:])] == 1
    assert by[("paged_attention_kv", str(kv_dtype)[6:])] == 1


@pytest.mark.parametrize("d", [12, 64, 128, 256, 384])
def test_flash_wrappers_take_float16_on_the_cuda_cores(d, fake_lib):
    """float16's forward (B5, B6) and backward (B7, B8) run on the tensor
    cores where bf16's do (d % 8 == 0, d <= 128), with dtype code 2, and
    never reach the CUDA-core entries there; on the CUDA cores at other
    d."""
    q = _cuda(torch.zeros((2, 4, d), dtype=F16))
    stat = _cuda(torch.zeros((2, 4, 1)))
    tc = d % 8 == 0 and d <= 128
    route = "wgmma" if tc else "cuda_cores"
    assert kernels.flash_fwd_route(F16, d) == route
    assert kernels.flash_bwd_route(F16, d) == route
    o = kernels.flash_fwd_cuda(q, q, q, True, 0.5, False)
    o2, lse = kernels.flash_fwd_cuda(q, q, q, True, 0.5, True)
    dq = kernels.flash_bwd_dq_cuda(q, q, q, q, stat, stat, True, 0.5)
    dk, dv = kernels.flash_bwd_dkv_cuda(q, q, q, q, stat, stat, True, 0.5)
    assert {t.dtype for t in (o, o2, dq, dk, dv)} == {F16}
    assert lse.dtype == torch.float32
    suffix = "_wgmma" if tc else ""
    assert fake_lib.calls == [
        ("mx_flash_fwd" + suffix, 2, 0, d, 0),
        ("mx_flash_fwd" + suffix, 2, 0, d, 1),
        ("mx_flash_bwd_dq" + suffix, 2, 0, d),
        ("mx_flash_bwd_dkv" + suffix, 2, 0, d)]
    names = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    counts = kernels.launch_counts()
    assert all(counts[n] == 1 for n in names)
    assert {n: counts[n] for n in counts if n.endswith("_wgmma")} == dict(
        {n + "_wgmma": int(tc) for n in names}, paged_attention_wgmma=0)
    assert kernels.launch_counts_by_dtype() == {
        (n + s, "float16"): 1 for n in names
        for s in (("", "_wgmma") if tc else ("",))}


@pytest.mark.parametrize("d", [8, 64, 96, 128])
@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1), (F16, 2)],
                         ids=["bfloat16", "float16"])
def test_flash_wgmma_forward_takes_the_dtype_code(dtype, code, d, fake_lib):
    """The tensor-core forward's entry receives the one table's code of
    its type: 1 for bfloat16, 2 for float16."""
    q = _cuda(torch.zeros((3, 5, d), dtype=dtype))
    kernels.flash_fwd_cuda(q, q, q, False, 0.25, False)
    kernels.flash_fwd_cuda(q, q, q, False, 0.25, True)
    assert fake_lib.calls == [("mx_flash_fwd_wgmma", code, 0, d, 0),
                              ("mx_flash_fwd_wgmma", code, 0, d, 1)]
    assert kernels.launch_counts()["flash_fwd_wgmma"] == 1
    assert kernels.launch_counts()["flash_fwd_lse_wgmma"] == 1


@pytest.mark.parametrize("d", [8, 64, 96, 128])
@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1), (F16, 2)],
                         ids=["bfloat16", "float16"])
def test_flash_wgmma_backward_takes_the_dtype_code(dtype, code, d,
                                                   fake_lib):
    """Both tensor-core backward entries (B7, B8) receive the one table's
    code of their type: 1 for bfloat16, 2 for float16; no CUDA-core entry
    is reached, and each launch counts on its tensor-core counter, by type
    too."""
    q = _cuda(torch.zeros((3, 5, d), dtype=dtype))
    stat = _cuda(torch.zeros((3, 5, 1)))
    dq = kernels.flash_bwd_dq_cuda(q, q, q, q, stat, stat, True, 0.25)
    dk, dv = kernels.flash_bwd_dkv_cuda(q, q, q, q, stat, stat, True, 0.25)
    assert {t.dtype for t in (dq, dk, dv)} == {dtype}
    assert fake_lib.calls == [("mx_flash_bwd_dq_wgmma", code, 0, d),
                              ("mx_flash_bwd_dkv_wgmma", code, 0, d)]
    counts = kernels.launch_counts()
    assert counts["flash_bwd_dq_wgmma"] == counts["flash_bwd_dkv_wgmma"] == 1
    name = str(dtype).replace("torch.", "")
    assert kernels.launch_counts_by_dtype() == {
        (n, name): 1 for n in ("flash_bwd_dq", "flash_bwd_dq_wgmma",
                               "flash_bwd_dkv", "flash_bwd_dkv_wgmma")}


def test_fused_ops_send_float16_cuda_tensors_to_the_kernels(fake_lib,
                                                            monkeypatch):
    """`fused.bias_act` on a float16 CUDA tensor launches the kernel; no
    float16 CUDA tensor reaches a plain version."""
    def refuse(*a, **k):
        raise AssertionError("a float16 CUDA tensor took a plain version")
    monkeypatch.setattr(fused, "apply_ref", refuse)
    x = _cuda(torch.zeros((8, 16), dtype=F16))
    out = fused.bias_act(x, _cuda(torch.zeros(16)), act_type="relu")
    assert out.dtype == F16 and fake_lib.calls[0][:2] == (
        "mx_scale_shift_act", 2)


def test_one_dtype_code_table():
    assert kernels.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                                   F16: 2, torch.int8: 3, torch.uint8: 4,
                                   torch.bool: 5, torch.int16: 6,
                                   torch.int32: 7}
    csrc = os.path.join(os.path.dirname(kernels.__file__), "csrc")

    def text(name):
        with open(os.path.join(csrc, name)) as f:
            return " ".join(f.read().split())
    assert "dtype: 0 float32, 1 bfloat16, 2 float16" in text(
        "scale_shift_act.cu")
    assert "dtype: 0 float32, 1 bfloat16, 2 float16" in text(
        "flash_attention.cu")
    assert "dtype: 0 float32, 1 bfloat16, 2 float16" in text("avg_pool2d.cu")
    pa_text = text("paged_attention.cu")
    assert "q_dtype: 0 float32, 1 bfloat16, 2 float16" in pa_text
    assert "kv_dtype: 0 float32, 1 bfloat16, 2 float16, 3 int8" in pa_text
    ia_text = text("image_augment.cu")
    assert ("in_dtype: 0 float32, 3 int8, 4 uint8, 5 bool, 6 int16, "
            "7 int32") in ia_text
    assert "out_dtype: 0 float32, 1 bfloat16, 2 float16" in ia_text
    # the refusal table keeps its rows: float16 adds none (the augment
    # kernel's crop that does not fit, cut on fewer than 3 channels and
    # mean / std that do not broadcast are the JAX package's refusals too)
    assert [r[0] for r in kernels.RULES] == ["scale_shift_act", "avg_pool2d",
                                             "image_augment", "image_augment",
                                             "image_augment"]


# ---------------------------------------------------------------------------
# plain versions in float16 against the JAX package's ops in float16
# ---------------------------------------------------------------------------
def _f16(a):
    return np.asarray(a, np.float16)


def _assert_f16_close(got, want, rel=STEP, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want), 2.0 ** -14)
    bad = np.abs(got - want) > rel * scale * 1.0001
    assert not bad.any(), (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("act", ["relu", "gelu", None])
def test_bias_act_float16_matches_jax(act):
    rng = np.random.RandomState(1)
    x = _f16(rng.randn(6, 24))
    b = rng.randn(24).astype(np.float32)
    want = np.asarray(jfused.bias_act(jnp.asarray(x), jnp.asarray(b),
                                      act_type=act, axis=-1, interpret=True))
    got = fused.bias_act(torch.from_numpy(x), torch.from_numpy(b),
                         act_type=act)
    assert got.dtype == F16
    _assert_f16_close(got.numpy(), want, what=act)


def test_batch_norm_float16_matches_jax():
    rng = np.random.RandomState(2)
    x = _f16(rng.randn(4, 3, 3, 8))
    g, b = (1 + 0.2 * rng.randn(8)).astype(np.float32), \
        (0.1 * rng.randn(8)).astype(np.float32)
    rm, rv = np.zeros(8, np.float32), np.ones(8, np.float32)
    want, wm, wv = jfused.batch_norm(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(rm),
        jnp.asarray(rv), axis=-1, act_type="relu", interpret=True)
    got, gm, gv = fused.batch_norm(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in (g, b, rm, rv)),
        training=True, axis=-1, act_type="relu")
    assert got.dtype == F16
    _assert_f16_close(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_float16_matches_jax(causal):
    rng = np.random.RandomState(3)
    q, k, v, g = (_f16(rng.randn(2, 128, 32) * 0.5) for _ in range(4))
    fn = lambda a, b, c: pa.flash_attention(a, b, c, causal=causal,
                                            interpret=True)
    o, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = attention.flash_attention(*ts, causal=causal)
    got_g = torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert out.dtype == F16 and all(t.dtype == F16 for t in got_g)
    _assert_f16_close(out.detach().numpy(), np.asarray(o), what="o")
    for name, a, b in zip("qkv", got_g, want_g):
        _assert_f16_close(a.numpy(), np.asarray(b), rel=2.0 ** -8,
                          what=f"d{name}")


def test_paged_attention_float16_matches_jax_reference():
    rng = np.random.RandomState(4)
    S, C, H, D, T = 3, 4, 2, 16, 40
    q = _f16(rng.randn(S, C, H, D))
    k, v = (_f16(rng.randn(S + 1, 2, T, H, D)) for _ in range(2))
    lens = np.array([0, 17, 36], np.int32)
    want = np.asarray(jfused.paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, lens)), 1, interpret=True))
    got = fused.paged_attention(*(torch.from_numpy(a)
                                  for a in (q, k, v, lens)), 1)
    assert got.dtype == F16
    _assert_f16_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# AMP
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _amp_off_scope():
    """What `amp_off` runs around a test: both packages' AMP off after it,
    and the JAX package's whole AMP state as it found it (its `uninit()`
    keeps the target dtype, which a later JAX test would then autocast to)."""
    with jax_amp_restored():
        try:
            yield
        finally:
            tamp.uninit()
            jamp.uninit()


@pytest.fixture
def amp_off():
    with _amp_off_scope():
        yield


def test_amp_off_leaves_the_jax_packages_amp_as_it_found_it():
    """A test under `amp_off` that sets float16 in the JAX package leaves
    its target dtype bfloat16: a clean `autocast()` matmul is bfloat16."""
    with _amp_off_scope():
        jamp.init("float16")
        tamp.init("float16")
        jamp.FP32_FUNCS.add("mystery_op")
    assert jamp.target_dtype() == "bfloat16"
    assert not jamp.is_active() and "mystery_op" not in jamp.FP32_FUNCS
    a = mx.np.ones((8, 8))
    with jamp.autocast():
        out = mx.np.matmul(a, a)
    assert str(out.dtype) == "bfloat16"
    assert str(mx.np.matmul(a, a).dtype) == "float32"


def test_amp_init_float16_casts_as_jax(amp_off):
    with pytest.raises(MXNetError, match="bfloat16 or float16"):
        tamp.init("float8")
    tamp.init("float16")
    assert tamp.is_active() and tamp.target_dtype() == "float16"
    assert tamp.BF16_FUNCS == jlists.BF16_FUNCS
    assert tamp.FP32_FUNCS == jlists.FP32_FUNCS
    for op in ("dense", "convolution", "softmax", "layer_norm", "mystery"):
        jamp.init("float16")
        want = jamp.amp_dtype_for(op)
        assert tamp.amp_dtype_for(op) == want
    x32 = torch.ones(2)
    (y,) = tamp.cast_inputs("dense", "neutral", x32)
    assert y.dtype == F16
    (y,) = tamp.cast_inputs("layer_norm", "neutral", y)
    assert y.dtype == torch.float32
    assert tamp.op_dtype("fused_bias_act", "safe") == "float16"


def test_dense_under_float16_amp_matches_jax(amp_off):
    rng = np.random.RandomState(5)
    w = (rng.randn(6, 5) * 0.3).astype(np.float32)
    b = (rng.randn(6) * 0.1).astype(np.float32)
    x = rng.randn(3, 5).astype(np.float32)
    jd = jgluon.nn.Dense(6, in_units=5)
    jd.initialize()
    jd.weight.set_data(mx.np.array(w))
    jd.bias.set_data(mx.np.array(b))
    td = tgluon.nn.Dense(6, in_units=5).initialize(device="cpu")
    tgluon.params_from_jax(td, {"weight": w, "bias": b})
    jamp.init("float16")
    tamp.init("float16")
    want = jd(mx.np.array(x))
    got = td(torch.from_numpy(x))
    assert str(want.dtype) == "float16" and got.dtype == F16
    _assert_f16_close(got.detach().numpy(), want.asnumpy(), rel=2 * STEP)


class _Grads:
    """Parameters whose gradients the test sets directly."""

    def __init__(self, pkg, grads):
        self.params = []
        for g in grads:
            if pkg == "jax":
                p = jgluon.Parameter(shape=g.shape)
                p.initialize()
                p._data.grad[:] = mx.np.array(g)
            else:
                p = tgluon.Parameter(shape=g.shape)
                p.initialize(device=torch.device("cpu"))
                p.grad()[:] = torch.from_numpy(g)
            self.params.append(p)


def test_loss_scaler_matches_jax_over_one_overflow_sequence():
    """x2 after `scale_window` good steps, /2 on an overflow, never below
    1: the port's LossScaler gives the JAX package's scales."""
    seq = [False, False, False, True, False, False, False, True, True, True,
           True, True, True, True, True, True, True, True, True, True, True,
           False, False, False]
    scalers = {"jax": jamp.LossScaler(init_scale=2 ** 6, scale_window=3),
               "port": tamp.LossScaler(init_scale=2 ** 6, scale_window=3)}
    scales = {k: [] for k in scalers}
    for bad in seq:
        g = np.ones((3, 2), np.float32)
        if bad:
            g[1, 0] = np.inf
        for k, sc in scalers.items():
            params = _Grads(k, [g, np.zeros(4, np.float32)]).params
            overflow = sc.has_overflow(params)
            assert overflow == bad
            scales[k].append(sc.loss_scale)
    assert scales["port"] == scales["jax"]
    assert min(scales["port"]) == 1.0 and max(scales["port"]) == 2 ** 7


def test_scale_loss_and_overflow_step_on_a_trainer(amp_off):
    net = tgluon.nn.Dense(2, in_units=3).initialize(device="cpu", seed=1)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tamp.init_trainer(tr)
    scale = tr._amp_loss_scaler.loss_scale
    x = torch.ones(4, 3)
    with ag.record():
        loss = net(x).sum()
    with tamp.scale_loss(loss, tr) as scaled:
        assert float(scaled) == float(loss) * scale
        ag.backward(scaled)
    w0 = net.weight.detach().clone()
    assert tamp.step_with_overflow_check(tr, 4)
    # the trainer divided the scale back out: the plain SGD update
    torch.testing.assert_close(net.weight, w0 - 0.1 * torch.ones(2, 3),
                               rtol=1e-6, atol=1e-6)
    with ag.record():
        loss = net(x).sum()
    with tamp.scale_loss(loss, tr) as scaled:
        ag.backward(scaled)
    net.weight.grad[0, 0] = float("inf")
    w1 = net.weight.detach().clone()
    assert not tamp.step_with_overflow_check(tr, 4)
    assert torch.equal(net.weight, w1)
    assert tr._amp_loss_scaler.loss_scale == scale / 2
    with pytest.raises(MXNetError, match="has not been updated"):
        tr.step(4)                      # the skipped step consumed them


def test_float16_decoder_serves_on_the_cpu():
    """A float16 `CachedDecoder` (a float16 pool) serves through the
    engine, token-exact against its 1-slot reference: the prefill masks
    with float16's lowest value where -1e30 does not fit (the JAX
    package's -1e30 rounds to -inf there; both give a zero weight)."""
    from incubator_mxnet_tpu_torch import serve as tserve
    model = tserve.CachedDecoder(tserve.DecoderConfig(max_len=64,
                                                      dtype="float16"),
                                 seed=0, device="cpu")
    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, model.config.vocab, size=n).tolist()
               for n in (3, 17, 36)]
    with tserve.ContinuousEngine(model, max_slots=4) as eng:
        assert eng.pool.k.dtype == F16
        outs = [eng.submit(p, 8).result(timeout=120) for p in prompts]
        window = eng.prefill_window
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(
            o, model.reference_generate(p, 8, window=window))
