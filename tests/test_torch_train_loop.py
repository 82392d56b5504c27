"""PyTorch port: the imperative Gluon training loop as a whole, against
the JAX package, on the CPU:

    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)          # loss.backward() in the JAX package
    trainer.step(batch_size)

  * a 2-layer narrow BERT (the LayerNorm and head built without channel
    counts) through LAMB with a PolyScheduler and wd_mult 0 on beta,
    gamma and bias, as GluonNLP's pretraining sets it (the JAX flash
    kernels in interpret mode);
  * a thumbnail ResNet v1 under `fused.set_fusion_default(True)` through
    NAG with a CosineScheduler (the JAX fused ops' Pallas kernels in
    interpret mode), which must route through the fused ops in the eager
    loop;
  * the Trainer loop against `FusedTrainStep` from the same weights
    (Adam), and grad_req "add" over two half-batches against "write" over
    the whole batch (SGD with momentum, linear in the gradient: Adam would
    scale the half-sums' roundoff on near-zero gradients to whole steps).

Tolerances: float32 on both sides with sums in other orders, carried
over 3 steps: losses to rtol 1e-4, weights to rtol 2e-4 + atol 2e-5 (the
port's own two paths: rtol 1e-5).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import lr_scheduler as jlr
from incubator_mxnet_tpu.ops import fused as jfused

from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import lr_scheduler as tlr
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep
from incubator_mxnet_tpu_torch.ops import fused as tfused

from torch_port_utils import (encoder_lm_pair, token_batch, resnet_pair,
                              resnet_batch, jax_values, port_values,
                              assert_values_close)

torch.set_num_threads(1)

STEPS = 3
LOSS_RTOL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
NO_DECAY = ".*beta|.*gamma|.*bias"
KEY_BIAS = "attention.key_proj.bias"


def _jax_loop(jnet, trainer, batches):
    L = jgluon.loss.SoftmaxCrossEntropyLoss()
    losses, rates = [], []
    for x, y in batches:
        rates.append(trainer.learning_rate)
        with jag.record():
            loss = L(jnet(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        trainer.step(len(x))
        losses.append(float(loss.mean().asnumpy()))
    return losses, rates


def _port_loop(tnet, trainer, batches):
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    losses, rates = [], []
    for x, y in batches:
        rates.append(trainer.learning_rate)
        with ag.record():
            loss = L(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        ag.backward(loss)                      # per-sample: ones as seed
        trainer.step(len(x))
        losses.append(float(loss.mean()))
    return losses, rates


def _no_decay(net):
    for p in net.collect_params(NO_DECAY).values():
        p.wd_mult = 0.0


def test_bert_lamb_poly_loop_matches_jax():
    jnet, tnet = encoder_lm_pair(layers=2, use_flash=True, seed=4,
                                 deferred=True)
    batches = [token_batch(seed=20 + k) for k in range(STEPS)]
    kw = {"learning_rate": 1e-2, "wd": 0.01, "epsilon": 1e-6}
    _no_decay(jnet)
    _no_decay(tnet)
    assert sorted(tnet.collect_params(NO_DECAY)) == \
        sorted(jnet.collect_params(NO_DECAY))
    jtr = jgluon.Trainer(jnet.collect_params(), "lamb", dict(
        kw, lr_scheduler=jlr.PolyScheduler(max_update=4, base_lr=1e-2,
                                           pwr=1, warmup_steps=1)))
    ttr = tgluon.Trainer(tnet.collect_params(), "lamb", dict(
        kw, lr_scheduler=tlr.PolyScheduler(max_update=4, base_lr=1e-2,
                                           pwr=1, warmup_steps=1)))
    want, want_lr = _jax_loop(jnet, jtr, batches)
    got, got_lr = _port_loop(tnet, ttr, batches)
    assert got_lr == want_lr and len(set(got_lr)) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # a key projection's bias shifts every score of a row alike, which the
    # softmax cancels: its gradient is roundoff, which LAMB's trust ratio
    # scales to a full step in either package
    held = lambda vals: {n: v for n, v in vals.items()
                         if not n.endswith(KEY_BIAS)}
    assert_values_close(held(port_values(tnet)), held(jax_values(jnet)),
                        RTOL, ATOL, "after 3 LAMB steps:")


def test_resnet_nag_cosine_loop_with_fusion_default_matches_jax(
        monkeypatch):
    jnet, tnet = resnet_pair(True, seed=5)
    batches = [resnet_batch(True, seed=30 + k) for k in range(STEPS)]
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "nag", dict(
        kw, lr_scheduler=jlr.CosineScheduler(max_update=6, base_lr=0.1,
                                             warmup_steps=1)))
    ttr = tgluon.Trainer(tnet.collect_params(), "nag", dict(
        kw, lr_scheduler=tlr.CosineScheduler(max_update=6, base_lr=0.1,
                                             warmup_steps=1)))
    applies = []
    plain = tfused._apply_fwd

    def counting(x2d, *a):
        applies.append(tuple(x2d.shape))
        return plain(x2d, *a)
    monkeypatch.setattr(tfused, "_apply_fwd", counting)
    jprev = jfused.set_fusion_default(True)
    iprev = jfused.set_interpret(True)
    tprev = tfused.set_fusion_default(True)
    try:
        want, want_lr = _jax_loop(jnet, jtr, batches)
        got, got_lr = _port_loop(tnet, ttr, batches)
    finally:
        jfused.set_fusion_default(jprev)
        jfused.set_interpret(iprev)
        tfused.set_fusion_default(tprev)
    assert got_lr == want_lr
    # every BN of the thumbnail net took the fused apply, each step
    n_bn = sum(1 for n in tnet.collect_params() if n.endswith("gamma"))
    assert len(applies) == n_bn * STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_values_close(port_values(tnet), jax_values(jnet), RTOL, ATOL,
                        "after 3 NAG steps:")


def _port_pair(seed=6):
    """Two port encoders holding the same values."""
    return [encoder_lm_pair(layers=1, use_flash=True, seed=seed)[1]
            for _ in range(2)]


def test_trainer_loop_equals_fused_train_step():
    a, b = _port_pair()
    batches = [token_batch(seed=40 + k) for k in range(STEPS)]
    kw = {"learning_rate": 1e-3, "wd": 0.01}
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    tr = tgluon.Trainer(a.collect_params(), "adam", dict(kw))
    got, _ = _port_loop(a, tr, batches)
    step = FusedTrainStep(b, lambda n, x, y: L(n(x), y).sum(),
                          topt.create("adam", rescale_grad=1.0 / 2, **kw))
    want = [float(step(torch.from_numpy(x), torch.from_numpy(y))) / 2
            for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_values_close(port_values(a), port_values(b), 1e-5, 1e-7,
                        "Trainer against FusedTrainStep:")


def test_grad_req_add_over_half_batches_equals_write_over_the_batch():
    a, b = _port_pair(seed=7)
    x, y = token_batch(seed=50, batch=4)
    L = tgluon.loss.SoftmaxCrossEntropyLoss()
    a.setattr("grad_req", "add")
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    tra = tgluon.Trainer(a.collect_params(), "sgd", dict(sgd))
    trb = tgluon.Trainer(b.collect_params(), "sgd", dict(sgd))
    for _ in range(2):
        for half in (slice(0, 2), slice(2, 4)):
            with ag.record():
                loss = L(a(torch.from_numpy(x[half])),
                         torch.from_numpy(y[half]))
            ag.backward(loss)
        tra.step(4)
        with ag.record():
            loss = L(b(torch.from_numpy(x)), torch.from_numpy(y))
        ag.backward(loss)
        trb.step(4)
    assert_values_close(port_values(a), port_values(b), 1e-5, 1e-7,
                        "add over halves against write:")
