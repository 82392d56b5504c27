"""PyTorch port: the Gluon transformer layers, their ops, AMP casts, Adam
and AdamW, against the JAX package.

Blocks at units 32, 4 heads, FFN 64, T 16, dropout 0, hold the same numpy
values in both packages (`torch_port_utils.carry_values`, through
`gluon.params_from_jax`). The JAX flash path runs as the JAX package runs
it on the CPU (its differentiable blockwise scan); the port's runs its
`autograd.Function` over the kernels' plain versions.

Tolerances, float32 on both sides with sums in other orders: 1e-4 on block
outputs, 2e-4 on gradients. Three Adam `FusedTrainStep` steps: 1e-4
relative on the losses, 2e-4 relative + 2e-5 absolute on every weight.
Under bf16 AMP both packages round at the same op boundaries but their
bf16 products accumulate differently: 2e-3 relative on the losses, 0.1
on each weight's update relative to its own norm.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import numpy_extension as npx
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu.ops import pallas_attention as jpa
from incubator_mxnet_tpu.ops.registry import invoke as jinvoke

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TStep
from incubator_mxnet_tpu_torch.ops import attention, nn as tops

from torch_port_utils import (TRANSFORMER, carry_values, encoder_lm_pair,
                              token_batch, port_values, assert_values_close,
                              jax_amp_restored)

torch.set_num_threads(1)

VAL_TOL = 1e-4
GRAD_TOL = 2e-4
U, H, HID, T = (TRANSFORMER[k] for k in ("units", "heads", "hidden", "seq"))


def _blocks(kind, use_flash):
    """(JAX block, port block) of one kind, same values."""
    def make(nn):
        if kind == "attention":
            return nn.MultiHeadAttention(U, H, use_flash=use_flash)
        if kind == "encoder":
            return nn.TransformerEncoderCell(U, HID, H, dropout=0.0,
                                             use_flash=use_flash)
        return nn.TransformerDecoderCell(U, HID, H, dropout=0.0,
                                         use_flash=use_flash)
    jblk = make(jgluon.nn)
    jblk.initialize()
    tblk = make(tgluon.nn).initialize(device="cpu")
    carry_values(jblk, tblk, seed=5)
    return jblk, tblk


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, T, U).astype(np.float32)
    cot = rng.randn(2, T, U).astype(np.float32)
    extra = [rng.randn(2, 12, U).astype(np.float32)] \
        if kind == "decoder" else []
    return x, extra, cot


def _jax_run(jblk, x, extra, cot, **kw):
    """Output and parameter gradients of sum(out * cot)."""
    with jautograd.record():
        out = jblk(mx.np.array(x), *(mx.np.array(e) for e in extra), **kw)
        loss = (out * mx.np.array(cot)).sum()
    loss.backward()
    return out.asnumpy(), {n: p.grad().asnumpy()
                           for n, p in jblk.collect_params().items()}


def _port_run(tblk, x, extra, cot, **kw):
    with autograd.record():
        out = tblk(torch.tensor(x), *(torch.tensor(e) for e in extra), **kw)
    params = tblk.collect_params()
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(),
                                [p.data() for p in params.values()])
    return out.detach().numpy(), {n: g.numpy()
                                  for n, g in zip(params, grads)}


@pytest.mark.parametrize("kind", ["attention", "encoder", "decoder"])
@pytest.mark.parametrize("use_flash", [True, False])
def test_blocks_match_jax(kind, use_flash):
    jblk, tblk = _blocks(kind, use_flash)
    x, extra, cot = _inputs(kind, seed=7)
    kw = {"causal": True} if kind == "attention" and use_flash else {}
    want, want_g = _jax_run(jblk, x, extra, cot, **kw)
    got, got_g = _port_run(tblk, x, extra, cot, **kw)
    np.testing.assert_allclose(got, want, rtol=VAL_TOL, atol=VAL_TOL)
    assert_values_close(got_g, want_g, GRAD_TOL, GRAD_TOL, "grad of")


@pytest.mark.parametrize("kind", ["attention", "encoder", "decoder"])
def test_masked_attention_takes_the_composition(kind, monkeypatch):
    """With a mask, flash blocks take scaled_dot_product_attention, as in
    the JAX package, and still match it."""
    jblk, tblk = _blocks(kind, use_flash=True)
    x, extra, cot = _inputs(kind, seed=8)
    mask = np.tril(np.ones((T, T), bool))[None, None].repeat(2, 0)
    mask[1, :, :, 10:] = False           # padded keys in the second row
    key = "self_mask" if kind == "decoder" else "mask"

    def refuse(*a, **k):
        raise AssertionError("a masked attention took the flash op")
    monkeypatch.setattr(attention, "flash_attention", refuse)
    want, want_g = _jax_run(jblk, x, extra, cot, **{key: mx.np.array(mask)})
    got, got_g = _port_run(tblk, x, extra, cot, **{key: torch.tensor(mask)})
    np.testing.assert_allclose(got, want, rtol=VAL_TOL, atol=VAL_TOL)
    assert_values_close(got_g, want_g, GRAD_TOL, GRAD_TOL, "grad of")


# ---------------------------------------------------------------------------
# C5: a Gluon forward outside record() records nothing and runs flash's
# LSE-free forward (B5), as the JAX package's primal path does
# ---------------------------------------------------------------------------
def _lse_flags(monkeypatch):
    """Record `with_lse` of each flash forward the port runs."""
    flags = []
    orig = attention._forward

    def forward(q, k, v, causal, scale, with_lse):
        flags.append(with_lse)
        return orig(q, k, v, causal, scale, with_lse)
    monkeypatch.setattr(attention, "_forward", forward)
    return flags


@pytest.mark.parametrize("scope", ["none", "predict_mode"])
def test_inference_forward_records_nothing_and_takes_b5(scope, monkeypatch):
    """`TransformerEncoderCell(32, 64, 4, use_flash=True)` called outside
    record() (and under predict_mode()) returns a tensor with no graph,
    runs the flash forward without the LSE, agrees with the JAX cell, and
    a backward from it raises in both packages."""
    flags = _lse_flags(monkeypatch)
    jblk, tblk = _blocks("encoder", use_flash=True)
    x, _, _ = _inputs("encoder", seed=9)
    want = jblk(mx.np.array(x))
    if scope == "predict_mode":
        with autograd.predict_mode():
            got = tblk(torch.tensor(x))
    else:
        got = tblk(torch.tensor(x))
    assert got.grad_fn is None and not got.requires_grad
    assert flags == [False]
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=VAL_TOL,
                               atol=VAL_TOL)
    with pytest.raises(MXNetError, match="not connected"):
        autograd.backward(got)
    with pytest.raises(mx.MXNetError):
        want.backward()


@pytest.mark.parametrize("batch", [1, 2])
def test_flash_takes_contiguous_heads_at_any_batch(batch, monkeypatch):
    """The kernels take no strided view: at batch 1 the (b*h, t, d)
    reshape of the transposed heads is a view, which MultiHeadAttention
    copies before the flash call (at batch > 1 the reshape copies); the
    output is unchanged."""
    seen = []
    orig = attention._forward

    def forward(q, k, v, causal, scale, with_lse):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return orig(q, k, v, causal, scale, with_lse)
    monkeypatch.setattr(attention, "_forward", forward)
    blk = tgluon.nn.MultiHeadAttention(32, 4, use_flash=True).initialize(
        device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(batch, 6, 32)
                         .astype(np.float32))
    got = blk(x)
    assert seen == [True]
    ref = tgluon.nn.MultiHeadAttention(32, 4).initialize(device="cpu")
    tgluon.params_from_jax(ref, {n: p.data().detach().numpy()
                                 for n, p in blk.collect_params().items()})
    torch.testing.assert_close(got, ref(x), rtol=1e-5, atol=1e-6)


def test_record_still_tapes_and_takes_b6(monkeypatch):
    """Inside record() the cell tapes, runs the flash forward with the LSE
    (B6), and its gradients are the ones `torch.autograd.grad` takes."""
    flags = _lse_flags(monkeypatch)
    _, tblk = _blocks("encoder", use_flash=True)
    x, _, cot = _inputs("encoder", seed=10)
    with autograd.record():
        out = tblk(torch.tensor(x))
        loss = (out * torch.tensor(cot)).sum()
    assert out.grad_fn is not None and flags == [True]
    params = tblk.collect_params()
    want = torch.autograd.grad(loss, [p.data() for p in params.values()],
                               retain_graph=True)
    autograd.backward(loss)
    for p, g in zip(params.values(), want):
        assert torch.equal(p.grad(), g)


def test_fused_train_step_still_tapes_and_matches_jax(monkeypatch):
    """FusedTrainStep's own scope counts as taping: every layer runs B6
    and the Adam steps match the JAX package's."""
    flags = _lse_flags(monkeypatch)
    jnet, tnet = encoder_lm_pair(layers=2, use_flash=True, seed=4)
    x, y = token_batch(seed=5)
    want = _jax_train(jnet, x, y)
    got = _port_train(tnet, x, y)
    assert flags == [True] * (2 * STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_values_close(port_values(tnet), _jax_weights(jnet), 2e-4, 2e-5,
                        "after 3 Adam steps:")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
def _op_cases(rng):
    x = rng.randn(2, 5, 8).astype(np.float32)
    g, b = (1 + 0.2 * rng.randn(8)).astype(np.float32), \
        (0.1 * rng.randn(8)).astype(np.float32)
    w = rng.randn(10, 8).astype(np.float32)
    idx = rng.randint(0, 10, size=(2, 5)).astype(np.int32)
    return {
        "layer_norm": (lambda a: npx.layer_norm(*a), tops.layer_norm,
                       (x, g, b)),
        "gelu": (lambda a: npx.gelu(a[0]), tops.gelu, (x,)),
        "softmax": (lambda a: npx.softmax(a[0], axis=-1), tops.softmax,
                    (x,)),
        "embedding": (lambda a: npx.embedding(*a), tops.embedding,
                      (idx, w)),
        "sdpa_causal": (
            lambda a: npx.scaled_dot_product_attention(*a, causal=True),
            lambda *a: tops.scaled_dot_product_attention(*a, causal=True),
            (x, x[:, ::-1].copy(), x * 0.5)),
    }


@pytest.mark.parametrize("name", ["layer_norm", "gelu", "softmax",
                                  "embedding", "sdpa_causal"])
def test_ops_match_jax(name):
    jfn, tfn, args = _op_cases(np.random.RandomState(3))[name]
    want = np.asarray(jfn([mx.np.array(a) for a in args]).asnumpy())
    got = tfn(*(torch.tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# AMP: each op runs in the dtype the JAX package's dispatch gives it
# ---------------------------------------------------------------------------
@jax_amp_restored()
def _amp_dtypes(x_dtype):
    """{op: output dtype name} in both packages under bf16 AMP, for float
    inputs of `x_dtype`."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 32).astype(np.float32)
    w = rng.randn(32, 32).astype(np.float32)
    g = np.ones(32, np.float32)
    idx = np.zeros((2, 4), np.int32)
    qkv = rng.randn(8, 4, 32).astype(np.float32)

    def jx(a):
        return mx.np.array(a).astype(x_dtype)

    def tx(a):
        return torch.tensor(a).to(getattr(torch, x_dtype))
    jamp.init("bfloat16")
    try:
        jflash = jinvoke(lambda q, k, v: jpa.flash_attention(q, k, v),
                         tuple(jx(qkv) for _ in range(3)),
                         name="flash_attention")
        j = {"layer_norm": npx.layer_norm(jx(x), jx(g), jx(g)),
             "fully_connected": npx.fully_connected(jx(x), jx(w), None,
                                                    no_bias=True,
                                                    flatten=False),
             "sdpa": npx.scaled_dot_product_attention(jx(x), jx(x), jx(x)),
             "gelu": npx.gelu(jx(x)),
             "embedding": npx.embedding(mx.np.array(idx), jx(w)),
             "add": jx(x) + jx(x), "reshape": jx(x).reshape((8, 32)),
             "transpose": jx(x).transpose((1, 0, 2)),
             "flash_attention": jflash}
        j = {k: str(v.dtype) for k, v in j.items()}
    finally:
        jamp.uninit()
    tamp.init("bfloat16")
    try:
        t = {"layer_norm": tops.layer_norm(tx(x), tx(g), tx(g)),
             "fully_connected": tops.fully_connected(tx(x), tx(w), None,
                                                     no_bias=True,
                                                     flatten=False),
             "sdpa": tops.scaled_dot_product_attention(tx(x), tx(x), tx(x)),
             "gelu": tops.gelu(tx(x)),
             "embedding": tops.embedding(torch.tensor(idx), tx(w)),
             "add": tops.add(tx(x), tx(x)),
             "reshape": tops.reshape(tx(x), (8, 32)),
             "transpose": tops.transpose(tx(x), (1, 0, 2)),
             "flash_attention": attention.flash_attention(
                 tx(qkv), tx(qkv), tx(qkv))}
        t = {k: str(v.dtype).split(".")[-1] for k, v in t.items()}
    finally:
        tamp.uninit()
    return j, t


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_amp_dtype_of_each_op_matches_jax(x_dtype):
    """layer_norm runs in float32 (`unsafe`), fully_connected, sdpa, add,
    reshape and transpose in bfloat16 (the lists and `safe`), and gelu,
    embedding and the unregistered `flash_attention` keep their inputs'
    dtype (no list names them, so JAX's invoke leaves them alone)."""
    j, t = _amp_dtypes(x_dtype)
    assert t == j
    assert t["layer_norm"] == "float32" and t["sdpa"] == "bfloat16"
    assert t["gelu"] == t["flash_attention"] == x_dtype


def test_encoder_feeds_flash_bf16_under_amp(monkeypatch):
    seen = []
    orig = attention.flash_attention

    def recording(q, k, v, causal=False, scale=None):
        seen.append((q.dtype, k.dtype, v.dtype))
        return orig(q, k, v, causal, scale)
    monkeypatch.setattr(attention, "flash_attention", recording)
    _, tblk = _blocks("encoder", use_flash=True)
    tamp.init("bfloat16")
    try:
        out = tblk(torch.randn(2, T, U))
    finally:
        tamp.uninit()
    assert seen == [(torch.bfloat16,) * 3]
    assert out.dtype == torch.bfloat16           # the residual add's dtype


# ---------------------------------------------------------------------------
# training: three Adam FusedTrainStep steps of a 2-layer encoder + head
# ---------------------------------------------------------------------------
STEPS = 3
# epsilon 1e-5: the key projection's bias has an exactly zero gradient in
# exact arithmetic (softmax is shift-invariant along each query's row), so
# both packages hand Adam roundoff there, which its normalisation would
# turn into full-size steps of arbitrary sign at the default 1e-8
ADAM = dict(learning_rate=1e-3, epsilon=1e-5)


@jax_amp_restored()
def _jax_train(jnet, x, y, amp_on=False):
    L = jgluon.loss.SoftmaxCrossEntropyLoss()
    step = JStep(jnet, lambda n, a, b: L(n(a), b).mean(),
                 jopt.create("adam", **ADAM))
    if amp_on:
        jamp.init("bfloat16")
    try:
        return [float(step(mx.np.array(x), mx.np.array(y)).asnumpy())
                for _ in range(STEPS)]
    finally:
        if amp_on:
            jamp.uninit()


def _port_train(tnet, x, y, amp_on=False):
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    step = TStep(tnet, lambda n, a, b: L(n(a), b).mean(),
                 topt.create("adam", **ADAM))
    if amp_on:
        tamp.init("bfloat16")
    try:
        return [float(step(torch.tensor(x), torch.tensor(y)))
                for _ in range(STEPS)]
    finally:
        if amp_on:
            tamp.uninit()


def _jax_weights(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


@pytest.mark.parametrize("use_flash", [True, False])
def test_adam_train_steps_match_jax(use_flash):
    jnet, tnet = encoder_lm_pair(layers=2, use_flash=use_flash)
    x, y = token_batch()
    want = _jax_train(jnet, x, y)
    got = _port_train(tnet, x, y)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert_values_close(port_values(tnet), _jax_weights(jnet), 2e-4, 2e-5,
                        "after 3 Adam steps:")


def test_amp_bf16_train_steps_match_jax(monkeypatch):
    """Three Adam steps under bf16 AMP: the flash op takes bf16 q, k, v in
    every layer of every step, the weights stay float32, and the losses
    and each weight's update agree with the JAX package's. The two
    packages' bf16 products sum in other orders, so the losses part by
    4e-4 and the updates (|dA - dB| / |dB|, Adam's normalised steps) by a
    median of 0.02 and at most 0.044; an all-float32 step parts from the
    JAX bf16 one by as much, which the dtypes recorded here rule out."""
    seen = []
    orig = attention.flash_attention

    def recording(q, k, v, causal=False, scale=None):
        seen.append((q.dtype, k.dtype, v.dtype))
        return orig(q, k, v, causal, scale)
    monkeypatch.setattr(attention, "flash_attention", recording)
    jnet, tnet = encoder_lm_pair(layers=2, use_flash=True, seed=2)
    w0 = {n: v.copy() for n, v in port_values(tnet).items()}
    x, y = token_batch(seed=3)
    want = _jax_train(jnet, x, y, amp_on=True)
    got = _port_train(tnet, x, y, amp_on=True)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert seen == [(torch.bfloat16,) * 3] * (2 * STEPS)
    assert all(p.data().dtype == torch.float32
               for p in tnet.collect_params().values())
    jw, tw = _jax_weights(jnet), port_values(tnet)
    for n in jw:
        if n.endswith("attention.key_proj.bias"):    # Adam on roundoff
            continue
        dj, dt = jw[n] - w0[n], tw[n] - w0[n]
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel < 0.1, f"bf16 update of {n} parts by {rel:.3e}"


def test_bert_layout_names_and_shapes_match_jax():
    jnet, tnet = encoder_lm_pair(layers=1)
    j = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    t = {n: tuple(v.shape) for n, v in tnet.collect_params().items()}
    assert t == j and len(t) == 22
    # a LayerNorm without in_channels takes its width from the first input
    ln = tgluon.nn.LayerNorm().initialize(device="cpu")
    with pytest.raises(tgluon.DeferredInitializationError):
        ln.collect_params()["gamma"].data()
    ln(torch.zeros(2, 3, TRANSFORMER["units"]))
    assert {n: p.shape for n, p in ln.collect_params().items()} == \
        {"gamma": (TRANSFORMER["units"],), "beta": (TRANSFORMER["units"],)}


# ---------------------------------------------------------------------------
# optimizer rules and dropout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_rules_match_jax(name):
    """Two updates of one weight with weight decay, rescale and clipping:
    Adam adds wd * w to the gradient, AdamW decays by lr * wd * w."""
    rng = np.random.RandomState(9)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) * 3 for _ in range(2)]
    kw = dict(learning_rate=0.01, wd=0.1, rescale_grad=0.5,
              clip_gradient=1.0, beta1=0.8, beta2=0.95, epsilon=1e-6)
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    jw, tw = mx.np.array(w0), torch.tensor(w0)
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, mx.np.array(g), js)
        to.update(0, tw, torch.tensor(g), ts)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)


def test_dropout_rate_and_scaling_with_a_fixed_generator():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    y = tops.dropout(x, 0.25, gen)
    kept = y != 0
    assert abs(1.0 - kept.float().mean().item() - 0.25) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.75))
    again = tops.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)
    assert tops.dropout(x, 0.25, gen, training=False) is x
    assert tops.dropout(x, 0.0, gen) is x
    xb = x.bfloat16()
    assert tops.dropout(xb, 0.25, gen).dtype == torch.bfloat16


def test_dropout_block_draws_only_in_training_mode():
    trandom.seed(7)
    blk = tgluon.nn.Dropout(0.5)
    x = torch.ones(64, 64)
    assert torch.equal(blk(x), x)                   # predict mode by default
    blk.train(True)                         # the module flag is not read
    assert torch.equal(blk(x), x)
    with autograd.train_mode():
        first = blk(x)
    assert 0.4 < (first == 0).float().mean().item() < 0.6
    trandom.seed(7)
    with autograd.record():
        assert torch.equal(blk(x), first)          # the seed replays it
    with autograd.record(train_mode=False):
        assert torch.equal(blk(x), x)


# ---------------------------------------------------------------------------
# chip_smoke.py's float32 flash-vs-SDPA check, on the small encoder
# ---------------------------------------------------------------------------
def _load_chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "planted"])
def test_flash_check_sees_a_dropped_delta(fault, monkeypatch):
    """The check at its optimizer, learning rate and step count: each
    weight's update with flash against the SDPA composition's stays far
    under the limit when sound, and goes over it when the flash backward
    drops delta = rowsum(dO * o), the softmax normaliser's term."""
    cs = _load_chip_smoke()
    nets = [encoder_lm_pair(use_flash=f, seed=12)[1] for f in (True, False)]
    init = encoder_lm_pair(seed=12)[1].collect_params()
    x, y = (torch.tensor(a) for a in token_batch(seed=13))
    if fault:
        orig = attention._backward

        def no_delta(q, k, v, do, lse, delta, causal, scale):
            return orig(q, k, v, do, lse, torch.zeros_like(delta), causal,
                        scale)
        monkeypatch.setattr(attention, "_backward", no_delta)
    losses = []
    for net in nets:
        step = cs.bert_step(net, topt.create(
            "sgd", learning_rate=cs.FLASH_CHECK_LR))
        losses.append([float(step(x, y))
                       for _ in range(cs.FLASH_CHECK_STEPS)])
    rel = cs.update_parting(init, nets[0].collect_params(),
                            nets[1].collect_params())
    held = [r for n, r in rel.items() if not n.endswith(cs.FLASH_CHECK_SKIP)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print(f"fault={fault}: worst update parting {max(held):.3e}, median "
          f"{np.median(held):.3e}, step-2 loss parting {loss_rel:.2e}")
    if fault:
        assert max(held) > 2 * cs.FLASH_CHECK_UPDATE_RTOL
    else:
        assert max(held) < cs.FLASH_CHECK_UPDATE_RTOL / 10
        assert loss_rel < cs.FLASH_CHECK_LOSS_RTOL
