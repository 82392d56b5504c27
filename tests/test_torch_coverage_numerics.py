"""PyTorch port: the plain versions against the JAX package at the shapes
the kernels' coverage added (ROADMAP C1).

On the CPU each fused op takes its kernel's plain version, the oracle
`chip_smoke.py` holds the kernel against on the card (phases 6 and 10). The
same numpy inputs go through the JAX package, its Pallas kernels in
interpret mode where they tile (as its own tests run them):
  * paged attention at head_dim 16, 24, 40, 160, 256, 320 and 384, float
    and int8
    slabs, against the Pallas kernel where it tiles and
    `paged_attention_ref` where the JAX dispatcher falls back;
  * a `Dense(10, "relu")` net through both packages' FusedTrainStep,
    fusion on;
  * the NHWC average pool at 12 channels, forward and gradient;
  * flash attention at head dims 12, 40, 96, 136, 192, 256, 320 and 384,
    causal and not: o, lse and the gradients of q, k and v;
  * the head_dim-16 ContinuousEngine, token-exact against the JAX engine.

Tolerances: float32 on both sides with sums in other orders, as the other
port tests state them: 1e-5 absolute on paged attention (2e-5 relative and
absolute on int8 slabs, whose dequantized values reach 14); 1e-4 on flash
values and lse, 2e-4 on its gradients; 1e-6 on the pool; 1e-4 relative on
the training losses and 2e-4 relative + 2e-5 absolute on the weights after
three steps. Tokens are compared exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu.ops import pallas_attention as pa
from incubator_mxnet_tpu.ops import pallas_kernels as PK

from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TStep
from incubator_mxnet_tpu_torch.ops import attention, fused as tfused

from torch_port_utils import decoders

torch.set_num_threads(1)

PAGED_ATOL = 1e-5
INT8_TOL = dict(rtol=2e-5, atol=2e-5)
VAL_TOL, GRAD_TOL = 1e-4, 2e-4


# ---------------------------------------------------------------------------
# paged attention at head dims off the 32/64/128 instances
# ---------------------------------------------------------------------------
def _paged_inputs(d, C, int8, seed):
    rng = np.random.RandomState(seed)
    S, H, T, L = 3, 2, 32, 2
    shape = (S + 1, L, T, H, d)
    if int8:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        sc = dict(k_scale=(rng.rand(S + 1, L, T) * 0.1 + 0.01)
                  .astype(np.float32),
                  v_scale=(rng.rand(S + 1, L, T) * 0.1 + 0.01)
                  .astype(np.float32))
    else:
        k = rng.randn(*shape).astype(np.float32)
        v = rng.randn(*shape).astype(np.float32)
        sc = {}
    q = rng.randn(S, C, H, d).astype(np.float32)
    lens = np.array([0, 9, T - C], dtype=np.int32)
    return q, k, v, lens, sc


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("d", [16, 24, 40, 160, 256, 320, 384])
def test_paged_plain_matches_jax_at_new_head_dims(d, C, int8):
    q, k, v, lens, sc = _paged_inputs(d, C, int8, seed=d + C + int8)
    got = tfused.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), 1,
        **{n: torch.from_numpy(a) for n, a in sc.items()}).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)] + [1]
    jsc = {n: jnp.asarray(a) for n, a in sc.items()}
    want = PK.paged_attention_fwd(*jargs, interpret=True, **jsc)
    if want is None:        # the JAX dispatcher's fallback for this shape
        want = jfused.paged_attention_ref(*jargs, **jsc)
    tol = INT8_TOL if int8 else dict(rtol=0, atol=PAGED_ATOL)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# Dense(10, "relu") through FusedTrainStep, fusion on
# ---------------------------------------------------------------------------
def _dense_pair(seed=0):
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(12, activation="relu"),
             jgluon.nn.Dense(10, activation="relu"))
    jnet.initialize()
    jnet(mx.np.zeros((2, 6)))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        v = (rng.randn(*p.shape) * 0.5).astype(np.float32)
        p.set_data(mx.np.array(v))
        values[name] = v
    tnet = tgluon.nn.HybridSequential(
        tgluon.nn.Dense(12, activation="relu", in_units=6),
        tgluon.nn.Dense(10, activation="relu", in_units=12)).initialize(
            device="cpu")
    tgluon.params_from_jax(tnet, values)
    return jnet, tnet


def test_fused_dense10_relu_steps_match_jax(monkeypatch):
    jnet, tnet = _dense_pair()
    rng = np.random.RandomState(1)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    sgd = dict(learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 8)
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()
    jstep = JStep(jnet, lambda n, a, b: jl(n(a), b).sum(),
                  jopt.create("sgd", **sgd), use_fusion=True)
    prev = jfused.set_interpret(True)
    try:
        want = [float(jstep(mx.np.array(x), mx.np.array(y)).asnumpy())
                for _ in range(3)]
    finally:
        jfused.set_interpret(prev)
    applies = []
    plain = tfused._apply_fwd

    def counting(x2d, *a):
        applies.append(tuple(x2d.shape))
        return plain(x2d, *a)
    monkeypatch.setattr(tfused, "_apply_fwd", counting)
    tl = tgluon.loss.SoftmaxCrossEntropyLoss()
    tstep = TStep(tnet, lambda n, a, b: tl(n(a), b).sum(),
                  topt.create("sgd", **sgd), use_fusion=True)
    got = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(3)]
    assert applies.count((8, 10)) == 3, applies    # the fused apply, C = 10
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(
            tnet.collect_params()[name].data().detach().numpy(),
            np.asarray(p.data().asnumpy()), rtol=2e-4, atol=2e-5,
            err_msg=name)


# ---------------------------------------------------------------------------
# the pool at 12 channels
# ---------------------------------------------------------------------------
def test_pool_at_12_channels_and_gradient_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 6, 12).astype(np.float32)
    g = rng.randn(2, 2, 2, 12).astype(np.float32)
    prev = jfused.set_interpret(True)
    try:
        want, vjp = jax.vjp(lambda a: jfused.avg_pool2d(a, (2, 3)),
                            jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    finally:
        jfused.set_interpret(prev)
    xt = torch.tensor(x, requires_grad=True)
    got = tfused.avg_pool2d(xt, (2, 3))
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention at head dims 12, 40, 96 and, past the tensor cores' 128,
# 136, 192, 256 (the capacity-256 instances)
# ---------------------------------------------------------------------------
def _qkv(d, seed, bh=2, t=64):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bh, t, d) * 0.5).astype(np.float32)
            for _ in range(3)] + [rng.randn(bh, t, d).astype(np.float32)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [12, 40, 96, 136, 192, 256, 320, 384])
def test_flash_matches_jax_kernels_at_new_head_dims(d, causal):
    q, k, v, g = _qkv(d, seed=d + causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o_j, vjp = jax.vjp(lambda a, b, c: pa.flash_attention(
        a, b, c, causal=causal, interpret=True), jq, jk, jv)
    grads_j = vjp(jnp.asarray(g))
    scale = 1.0 / np.sqrt(d)
    o6_j, lse_j = pa._flash_forward_lse(jq, jk, jv, causal, scale, 64, 64,
                                        True)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = attention.flash_attention(*ts, causal=causal)
    grads = torch.autograd.grad(o, ts, torch.from_numpy(g))
    o6, lse = attention.flash_forward_lse_ref(*(t.detach() for t in ts),
                                              causal, scale)
    close = np.testing.assert_allclose
    close(o.detach().numpy(), np.asarray(o_j), rtol=VAL_TOL, atol=VAL_TOL)
    close(o6.numpy(), np.asarray(o6_j), rtol=VAL_TOL, atol=VAL_TOL)
    close(lse.numpy(), np.asarray(lse_j), rtol=VAL_TOL, atol=VAL_TOL)
    for a, b, name in zip(grads, grads_j, "qkv"):
        close(a.numpy(), np.asarray(b), rtol=GRAD_TOL, atol=GRAD_TOL,
              err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the head_dim-16 engine (DecoderConfig's default head dim)
# ---------------------------------------------------------------------------
CFG16 = dict(vocab=64, embed=64, layers=2, heads=4, head_dim=16, max_len=48)


def test_head_dim_16_engine_token_exact_against_the_jax_engine():
    jm, tm = decoders(CFG16, seed=5)
    rng = np.random.RandomState(6)
    work = [(rng.randint(1, CFG16["vocab"],
                         size=rng.randint(2, 30)).tolist(),
             int(rng.randint(1, 12))) for _ in range(6)]
    knobs = dict(max_slots=3, decode_steps=2, prefill_window=16)
    outs = {}
    for name, eng in (("jax", jserve.ContinuousEngine(jm, **knobs)),
                      ("port", tserve.ContinuousEngine(tm, **knobs))):
        with eng:
            futs = [eng.submit(p, m) for p, m in work]
            outs[name] = [np.asarray(f.result(timeout=300)) for f in futs]
    for (p, m), a, b in zip(work, outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b, err_msg=f"prompt {len(p)}")
        np.testing.assert_array_equal(
            a, jm.reference_generate(p, m, window=16))
