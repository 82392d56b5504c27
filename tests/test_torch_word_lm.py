"""PyTorch port: the word language model as a whole (the slice's main
path), the port's example against the JAX package's.

`examples/torch_word_language_model.py`'s `RNNModel` (embedding, 2-layer
`rnn.LSTM`, dense over the vocabulary, optionally tied to the embedding)
against `examples/word_language_model.py`'s, at a small vocabulary, with
the same weights (`gluon.params_from_jax`) and the same tokens, through
both of the example's loops, two truncated-BPTT steps each (the states
carried, detached, from the first step to the second):

  * the fused step (`FusedTrainStep`: SGD, rescale 1/batch, clipping at
    clip * batch), untied: the JAX package's fused step does not take a
    net whose blocks share a Parameter (its aux-buffer bookkeeping raises
    KeyError), the port's does;
  * the imperative loop (`record`, `backward`, `npx.clip_by_global_norm`,
    `Trainer.step`), tied: both Trainers update the shared weight once;
  * the port's fused step on the tied net against the JAX package's
    imperative loop, clipping out of reach: the shared weight's gradient
    is the sum over both uses, applied once.

The summed losses must agree within 1e-5 relative, the states and every
updated weight within 1e-4 relative + 1e-5 absolute (float32; the
products sum in other orders and the errors compound over 2 x 5 recurrent
steps). Dropout is 0: the two packages draw from different generators.
"""
import os
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.gluon.contrib import FusedTrainStep as JStep
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.ops import kernels

from torch_port_utils import recurrent_value

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "examples"))
import torch_word_language_model as tlm  # noqa: E402
import word_language_model as jlm  # noqa: E402

V, E, L, T, N = 50, 16, 2, 5, 4
LR, CLIP = 0.5, 0.25
CPU = tmx.cpu()


def _pair(tied, seed=0):
    jnet = jlm.RNNModel(V, E, E, L, 0.0, tied)
    jnet.initialize(init="xavier")
    h, c = jnet.begin_state(N)
    jnet(jmx.np.array(np.zeros((T, N), np.int32)), h, c)
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        if name == "decoder.weight" and tied:
            values[name] = values["encoder.weight"]
            continue
        values[name] = recurrent_value(name, p.shape, rng)
        p.set_data(jmx.np.array(values[name]))
    tnet = tlm.RNNModel(V, E, E, L, 0.0, tied)
    tnet.initialize(device="cpu")
    tgluon.params_from_jax(tnet, values)
    return jnet, tnet


def _batches():
    ids = tlm.zipf_corpus(V, 3 * T * N + N, seed=1)
    data = tlm.batchify(ids, N)
    return [(data[i:i + T], data[i + 1:i + 1 + T].reshape(-1))
            for i in (0, T)]


def _jax_fused(jnet, clip):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    opt = jopt.create("sgd", learning_rate=LR, rescale_grad=1.0 / N)

    def fn(net, x, y, h, c):
        out, h2, c2 = net(x, h, c)
        return loss_fn(out, y).sum(), h2, c2
    step = JStep(jnet, fn, opt, clip_global_norm=clip * N)
    return lambda x, y, h, c: step(x, y, h, c)


def _jax_imperative(jnet, clip):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    trainer = jgluon.Trainer(jnet.collect_params(), "sgd",
                             {"learning_rate": LR})

    def step(x, y, h, c):
        h, c = h.detach(), c.detach()
        with jmx.autograd.record():
            out, h, c = jnet(x, h, c)
            loss = loss_fn(out, y).sum()
        loss.backward()
        grads = [p.grad() for p in jnet.collect_params().values()
                 if p.grad_req != "null"]
        jmx.npx.clip_by_global_norm(grads, clip * N)
        trainer.step(N)
        return loss, h, c
    return step


def _port_step(tnet, fused, clip):
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    if fused:
        return tlm.fused_step(tnet, loss_fn, LR, clip, N)
    trainer = tgluon.Trainer(tnet.collect_params(), "sgd",
                             {"learning_rate": LR})
    return lambda x, y, h, c: tlm.imperative_step(
        tnet, loss_fn, trainer, clip, N, x, y, h, c)


def _run(step, net, nd):
    h, c = net.begin_state(N)
    losses = []
    for x, y in _batches():
        loss, h, c = step(nd(x), nd(y), h, c)
        losses.append(float(loss.asnumpy()))
    return losses, h.asnumpy(), c.asnumpy()


def _assert_same(jnet, tnet, got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    tp = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(tp[name].data().detach().numpy(),
                                   p.data().asnumpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _port_nd(a):
    return tmx.np.array(a, device=CPU)


@pytest.mark.parametrize("fused", [True, False])
def test_two_steps_as_jax(fused):
    tied = not fused
    jnet, tnet = _pair(tied)
    want = _run((_jax_fused if fused else _jax_imperative)(jnet, CLIP),
                jnet, jmx.np.array)
    kernels.reset_launch_counts()
    got = _run(_port_step(tnet, fused, CLIP), tnet, _port_nd)
    assert all(np.isfinite(got[0]))
    _assert_same(jnet, tnet, got, want)
    # on the CPU the steps run the cell kernel's plain version
    assert kernels.launch_counts()["rnn_cell_fwd"] == 0


def test_tied_fused_step_counts_the_shared_weight_once():
    jnet, tnet = _pair(True, seed=2)
    want = _run(_jax_imperative(jnet, 1e6), jnet, jmx.np.array)
    got = _run(_port_step(tnet, True, 1e6), tnet, _port_nd)
    _assert_same(jnet, tnet, got, want)
    params = tnet.collect_params()
    assert params["decoder.weight"] is params["encoder.weight"]
    assert tnet.decoder.weight is tnet.encoder.weight


def test_losses_fall_over_the_example_loops():
    """A few more steps of each loop on the tied net at lr 1: the loss
    falls."""
    for fused in (True, False):
        tnet = tlm.RNNModel(V, E, E, L, 0.0, True)
        tnet.initialize(init="xavier", device="cpu")
        loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
        step = tlm.fused_step(tnet, loss_fn, 1.0, CLIP, N) if fused else \
            _port_step(tnet, False, CLIP)
        x, y = _batches()[0]
        h, c = tnet.begin_state(N)
        losses = []
        for _ in range(8):
            loss, h, c = step(_port_nd(x), _port_nd(y), h, c)
            losses.append(float(loss.asnumpy()))
        assert losses[-1] < losses[0], (fused, losses)
