"""PyTorch port: every `gluon.loss` against the JAX package's.

The same numpy inputs (made from a seed) go through both packages' loss
blocks; the values and the gradients with respect to the float inputs
(the JAX package's autograd, `record` + `backward` seeded with ones,
against torch autograd) must agree, with `weight`, `sample_weight` and
`batch_axis` where the loss takes them. float32 on both sides, one
elementwise chain each: 1e-5 relative + 1e-6 absolute on values and
gradients; CTC's recursion sums many log terms in another order: 1e-5
relative + 1e-5 absolute.

Under bf16 AMP (both packages' op lists), a bf16 prediction against a
float32 label: within two bf16 steps (2^-7) of the largest value. The JAX
package's eager steps round some intermediates to bf16 that its fused
steps and the port's type promotion keep in float32, so the two agree to
the type's step, not bit for bit.

CTC (blank 0): ragged `pred_lengths` and `label_lengths`, labels padded
with 0 and their lengths counted from the nonzero labels, the TNC layout,
and an alignment that cannot exist (more labels than frames), which gives
the JAX package's finite 1e30, not inf.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import gluon as jgluon

from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import gluon as tgluon

from torch_port_utils import jax_amp_restored

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CTC_ATOL = 1e-5


def _jax(loss, args, wrt, kwargs):
    nds = [mx.np.array(a) for a in args]
    for i in wrt:
        nds[i].attach_grad()
    kw = {k: mx.np.array(v) if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    with mx.autograd.record():
        out = loss(*nds, **kw)
    out.backward()
    return out.asnumpy(), [nds[i].grad.asnumpy() for i in wrt]


def _port(loss, args, wrt, kwargs):
    ts = [torch.tensor(a) for a in args]
    for i in wrt:
        ts[i].requires_grad_()
    kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    with tautograd.record():
        out = loss(*ts, **kw)
    out.backward(torch.ones_like(out))
    return out.detach().numpy(), [ts[i].grad.numpy() for i in wrt]


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _sign(rng, *shape):
    return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _prob(rng, *shape):
    return rng.uniform(0.05, 0.95, size=shape).astype(np.float32)


def _sw(rng):
    return rng.uniform(0.5, 1.5, size=(4, 1)).astype(np.float32)


# name -> (constructor kwargs, input builder (rng) -> (args, wrt, forward
# kwargs)); the loss class is looked up by name in each package
CASES = {
    "L1Loss": ({}, lambda g: ([_r(g, 4, 5), _r(g, 4, 5)], [0, 1], {})),
    "L1Loss-weighted": ({"weight": 0.7}, lambda g: (
        [_r(g, 4, 5), _r(g, 4, 5)], [0], {"sample_weight": _sw(g)})),
    "L1Loss-batch_axis1": ({"batch_axis": 1}, lambda g: (
        [_r(g, 4, 5, 2), _r(g, 4, 5, 2)], [0], {})),
    "L2Loss": ({}, lambda g: ([_r(g, 4, 5), _r(g, 4, 5)], [0, 1], {})),
    "L2Loss-weighted": ({"weight": 3.0, "batch_axis": 1}, lambda g: (
        [_r(g, 4, 6), _r(g, 4, 6)], [0], {"sample_weight": _sw(g)})),
    "SigmoidBinaryCrossEntropyLoss": ({}, lambda g: (
        [_r(g, 4, 5, scale=2), _prob(g, 4, 5)], [0], {})),
    "SigmoidBinaryCrossEntropyLoss-pos_weight": ({"weight": 0.5}, lambda g: (
        [_r(g, 4, 5, scale=2), (g.rand(4, 5) > 0.5).astype(np.float32)],
        [0], {"pos_weight": _prob(g, 5) * 3, "sample_weight": _sw(g)})),
    "SigmoidBCELoss-from_sigmoid": ({"from_sigmoid": True}, lambda g: (
        [_prob(g, 4, 5), _prob(g, 4, 5)], [0], {})),
    "SigmoidBCELoss-from_sigmoid-pos_weight": ({"from_sigmoid": True},
                                               lambda g: (
        [_prob(g, 4, 5), _prob(g, 4, 5)], [0],
        {"pos_weight": _prob(g, 5) * 2})),
    "SoftmaxCELoss": ({}, lambda g: (
        [_r(g, 4, 7), g.randint(0, 7, size=4).astype(np.int32)], [0],
        {"sample_weight": _sw(g)[:, 0]})),
    "SoftmaxCrossEntropyLoss-dense": ({"sparse_label": False}, lambda g: (
        [_r(g, 4, 7), _prob(g, 4, 7)], [0, 1], {})),
    "KLDivLoss": ({}, lambda g: (
        [np.log(_prob(g, 4, 6)), _prob(g, 4, 6)], [0, 1], {})),
    "KLDivLoss-logits": ({"from_logits": False, "weight": 2.0}, lambda g: (
        [_r(g, 4, 6), _prob(g, 4, 6)], [0, 1], {})),
    "HuberLoss": ({"rho": 0.5}, lambda g: (
        [_r(g, 4, 5), _r(g, 4, 5)], [0, 1], {"sample_weight": _sw(g)})),
    "HingeLoss": ({}, lambda g: ([_r(g, 4, 5), _sign(g, 4, 5)], [0], {})),
    "HingeLoss-margin": ({"margin": 2, "weight": 0.3}, lambda g: (
        [_r(g, 4, 5), _sign(g, 4, 5)], [0], {})),
    "SquaredHingeLoss": ({}, lambda g: (
        [_r(g, 4, 5), _sign(g, 4, 5)], [0], {"sample_weight": _sw(g)})),
    "LogisticLoss": ({}, lambda g: ([_r(g, 4, 5), _sign(g, 4, 5)], [0], {})),
    "LogisticLoss-binary": ({"label_format": "binary"}, lambda g: (
        [_r(g, 4, 5), (g.rand(4, 5) > 0.5).astype(np.float32)], [0], {})),
    "TripletLoss": ({"margin": 0.5}, lambda g: (
        [_r(g, 4, 6), _r(g, 4, 6), _r(g, 4, 6)], [0, 1, 2], {})),
    "TripletLoss-weighted": ({"weight": 2.0}, lambda g: (
        [_r(g, 4, 6), _r(g, 4, 6), _r(g, 4, 6)], [0],
        {"sample_weight": _sw(g)[:, 0]})),
    "PoissonNLLLoss": ({}, lambda g: (
        [_r(g, 4, 5, scale=0.5), g.poisson(2.0, (4, 5)).astype(np.float32)],
        [0], {})),
    "PoissonNLLLoss-full": ({"from_logits": False, "compute_full": True},
                            lambda g: (
        [_prob(g, 4, 5) * 4, g.poisson(3.0, (4, 5)).astype(np.float32)],
        [0], {"epsilon": 1e-6})),
    "CosineEmbeddingLoss": ({"margin": 0.2}, lambda g: (
        [_r(g, 4, 6), _r(g, 4, 6), _sign(g, 4)], [0, 1], {})),
    "CosineEmbeddingLoss-weighted": ({"weight": 0.5}, lambda g: (
        [_r(g, 4, 2, 3), _r(g, 4, 2, 3), _sign(g, 4)], [0, 1],
        {"sample_weight": _sw(g)[:, 0]})),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_values_and_gradients_match_jax(case):
    name = case.split("-")[0]
    ctor, build = CASES[case]
    args, wrt, kwargs = build(np.random.RandomState(len(case)))
    want, want_g = _jax(getattr(jgluon.loss, name)(**ctor), args, wrt,
                        kwargs)
    got, got_g = _port(getattr(tgluon.loss, name)(**ctor), args, wrt, kwargs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"gradient of input {wrt[i]}")


AMP_STEPS = 2 * 2.0 ** -8


@pytest.mark.parametrize("name,label", [
    ("L1Loss", "real"), ("L2Loss", "real"), ("HuberLoss", "real"),
    ("HingeLoss", "sign"), ("SquaredHingeLoss", "sign"),
    ("LogisticLoss", "sign"), ("SigmoidBCELoss", "binary"),
    ("KLDivLoss", "prob"), ("PoissonNLLLoss", "prob")])
@jax_amp_restored()
def test_losses_under_bf16_amp_match_jax(name, label):
    rng = np.random.RandomState(9)
    pred = _r(rng, 4, 5)
    lab = {"real": _r(rng, 4, 5), "sign": _sign(rng, 4, 5),
           "binary": (rng.rand(4, 5) > 0.5).astype(np.float32),
           "prob": _prob(rng, 4, 5)}[label]
    jamp.init("bfloat16")
    try:
        want = getattr(jgluon.loss, name)()(
            mx.np.array(pred).astype("bfloat16"), mx.np.array(lab))
        want = want.astype("float32").asnumpy()
    finally:
        jamp.uninit()
    tamp.init("bfloat16")
    try:
        got = getattr(tgluon.loss, name)()(torch.tensor(pred).bfloat16(),
                                           torch.tensor(lab))
    finally:
        tamp.uninit()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= \
        AMP_STEPS * np.abs(want).max()


def test_aliases_are_the_same_classes():
    assert tgluon.loss.SoftmaxCELoss is tgluon.loss.SoftmaxCrossEntropyLoss
    assert tgluon.loss.SigmoidBCELoss is \
        tgluon.loss.SigmoidBinaryCrossEntropyLoss


def _ctc_inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = _r(rng, 3, 12, 6)
    # ragged labels padded with the blank (0); a repeated label needs a
    # blank between its copies
    labels = np.array([[1, 2, 2, 3], [4, 1, 0, 0], [5, 0, 0, 0]], np.int32)
    return logits, labels


CTC_CASES = {
    "default_lengths": (lambda lg, lb: ([lg, lb], {}), {}),
    "ragged_lengths": (lambda lg, lb: ([lg, lb], {
        "pred_lengths": np.array([12, 9, 5], np.int32),
        "label_lengths": np.array([4, 2, 1], np.int32)}), {}),
    "tnc_weighted": (lambda lg, lb: (
        [np.ascontiguousarray(lg.transpose(1, 0, 2)), lb],
        {"sample_weight": np.array([0.5, 1.0, 2.0], np.float32)}),
        {"layout": "TNC", "weight": 0.3}),
    "label_tn": (lambda lg, lb: (
        [lg, np.ascontiguousarray(lb.T)], {}), {"label_layout": "TN"}),
}


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_values_and_gradients_match_jax(case):
    build, ctor = CTC_CASES[case]
    args, kwargs = build(*_ctc_inputs())
    want, (want_g,) = _jax(jgluon.loss.CTCLoss(**ctor), args, [0], kwargs)
    got, (got_g,) = _port(tgluon.loss.CTCLoss(**ctor), args, [0], kwargs)
    assert got.shape == want.shape == (3,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=CTC_ATOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=CTC_ATOL)


def test_ctc_impossible_alignment_is_the_jax_packages_finite_1e30():
    """Three distinct labels cannot fit in two frames: both packages give
    -log of a path sum of exp(-1e30), i.e. 1e30, finite; the possible
    sample beside it keeps its value."""
    rng = np.random.RandomState(5)
    logits = _r(rng, 2, 2, 5)
    labels = np.array([[1, 2, 3], [1, 0, 0]], np.int32)
    want = jgluon.loss.CTCLoss()(mx.np.array(logits),
                                 mx.np.array(labels)).asnumpy()
    got = tgluon.loss.CTCLoss()(torch.tensor(logits),
                                torch.tensor(labels)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert got[0] == pytest.approx(1e30, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=CTC_ATOL)
