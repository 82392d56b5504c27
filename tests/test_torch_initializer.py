"""PyTorch port: `initializer` against the JAX package's.

Deterministic initializers (Zero, One, Constant, Bilinear, LSTMBias, the
name dispatch and Mixed's routing) must give the JAX package's values
exactly. Random ones draw from another generator, so their moments are
compared: at >= 1e5 elements the standard deviation within 2% of the JAX
package's (the sampling error of either is about 0.2%) and the mean within
2% of that standard deviation. Orthogonal's rows (or columns) are
orthonormal times `scale`, within 1e-5.

The fans of a channels-last convolution weight differ on purpose: the port
stores every convolution weight (O, I/groups, kh, kw), so its fans are
MXNet's, which the JAX package's NCHW layer also gives; the JAX package's
NHWC layer reads them off its HWIO storage and draws about 9.2 times
narrower (`test_nhwc_fans_are_mxnets_where_the_jax_package_differs`).
"""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu import gluon as jgluon

from incubator_mxnet_tpu_torch import MXNetError, initializer as tinit
from incubator_mxnet_tpu_torch import gluon as tgluon

torch.set_num_threads(1)

STD_RTOL = 0.02
ORTHO_ATOL = 1e-5


def _port(init, name, shape, seed=0):
    return init(tinit.InitDesc(name), shape,
                torch.Generator().manual_seed(seed)).numpy()


def _jax(init, name, shape, seed=0):
    return np.asarray(init(jinit.InitDesc(name), shape, np.float32,
                           np.random.default_rng(seed)))


EXACT = {
    "zero": lambda m: m.Zero(),
    "one": lambda m: m.One(),
    "constant": lambda m: m.Constant(0.5),
    "constant_array": lambda m: m.Constant(np.arange(4, dtype=np.float32)),
    "bilinear": lambda m: m.Bilinear(),
    "lstm_bias": lambda m: m.LSTMBias(2.0),
}
NAMES = ["weight", "conv0_bias", "bn_gamma", "bn_beta", "running_mean",
         "running_var", "dense_weight_v"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", sorted(EXACT))
def test_deterministic_initializers_match_jax_exactly(kind, name):
    shape = (8, 3, 4, 4) if kind == "bilinear" else (
        (16,) if kind == "lstm_bias" else (3, 4))
    got = _port(EXACT[kind](tinit), name, shape)
    want = _jax(EXACT[kind](jinit), name, shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 2, 4, 4), (3, 1, 5, 3)])
def test_bilinear_and_lstm_bias_weights_match_jax_exactly(shape):
    """The draws themselves, past the name dispatch."""
    g = tinit.Bilinear()._init_weight(shape, None).numpy()
    np.testing.assert_array_equal(
        g, jinit.Bilinear()._init_weight(shape, np.float32, None))
    b = tinit.LSTMBias(1.5)._init_weight((12,), None).numpy()
    np.testing.assert_array_equal(
        b, jinit.LSTMBias(1.5)._init_weight((12,), np.float32, None))


@pytest.mark.parametrize("name", ["fc_bias", "bn_gamma", "conv_weight",
                                  "other"])
def test_mixed_routes_as_jax(name):
    def mixed(m):
        return m.Mixed([".*bias", ".*gamma", "conv.*"],
                       [m.Constant(3.0), "ones", m.Constant(-1.0)])
    if name == "other":
        with pytest.raises(MXNetError, match="matched no pattern"):
            _port(mixed(tinit), name, (2, 3))
        with pytest.raises(mx.MXNetError, match="matched no pattern"):
            _jax(mixed(jinit), name, (2, 3))
        return
    np.testing.assert_array_equal(_port(mixed(tinit), name, (2, 3)),
                                  _jax(mixed(jinit), name, (2, 3)))


def _random_inits(m):
    out = {"uniform": m.Uniform(0.1), "normal": m.Normal(0.05),
           "msraprelu": m.MSRAPrelu(), "msraprelu_in": m.MSRAPrelu("in", 0.1)}
    for rnd in ("uniform", "gaussian"):
        for fac in ("avg", "in", "out"):
            out[f"xavier_{rnd}_{fac}"] = m.Xavier(rnd, fac, 2.5)
    return out


# a Dense weight (out, in) and an NCHW convolution weight (O, I, kh, kw),
# each over 1e5 elements
SHAPES = {"dense": (256, 512), "conv_nchw": (128, 96, 3, 3)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", sorted(_random_inits(tinit)))
def test_random_initializer_moments_match_jax(kind, shape):
    shape = SHAPES[shape]
    got = _port(_random_inits(tinit)[kind], "weight", shape, seed=3)
    want = _jax(_random_inits(jinit)[kind], "weight", shape, seed=3)
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert abs(got.std() / want.std() - 1) < STD_RTOL, (got.std(),
                                                        want.std())
    assert abs(got.mean()) < STD_RTOL * want.std()


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(64, 128), (32, 16, 3, 3), (96, 40)])
def test_orthogonal_is_orthonormal_times_scale(shape, rand_type):
    scale = 1.3
    for mod, run in ((tinit, _port), (jinit, _jax)):
        q = run(mod.Orthogonal(scale, rand_type), "weight", shape)
        assert q.shape == shape
        q = q.reshape(shape[0], -1).astype(np.float64)
        gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                                   atol=ORTHO_ATOL)


@pytest.mark.parametrize("spec,kwargs,klass", [
    ("zeros", {}, "Zero"), ("ones", {}, "One"), ("msra", {}, "MSRAPrelu"),
    ("Xavier", {"magnitude": 2}, "Xavier"), ("normal", {"sigma": 0.5},
                                             "Normal"),
    ("constant", {"value": 2.0}, "Constant"), (None, {}, "Uniform")])
def test_create_by_name_and_alias_as_jax(spec, kwargs, klass):
    got, want = tinit.create(spec, **kwargs), jinit.create(spec, **kwargs)
    assert type(got).__name__ == type(want).__name__ == klass
    assert repr(got) == repr(want)
    inst = tinit.Xavier()
    assert tinit.create(inst) is inst


def test_create_refuses_an_unknown_name():
    with pytest.raises(MXNetError, match="unknown initializer"):
        tinit.create("no_such_init")
    with pytest.raises(mx.MXNetError, match="unknown initializer"):
        jinit.create("no_such_init")


def test_nhwc_fans_are_mxnets_where_the_jax_package_differs():
    """`Conv2D(256, 3, in_channels=256)` under MSRAPrelu: the port's NHWC
    std is the JAX package's NCHW std (MXNet's fans: 2304 in and out);
    the JAX package's NHWC std is sqrt(2304 / 196608) of it, about
    1/9.24, because it reads the fans off HWIO. If the JAX package is
    fixed, the last assertion fails."""
    def jax_std(layout):
        blk = jgluon.nn.Conv2D(256, 3, in_channels=256, layout=layout)
        blk.initialize(jinit.MSRAPrelu())
        return float(np.asarray(blk.weight.data().asnumpy()).std())

    port = tgluon.nn.Conv2D(256, 3, in_channels=256, layout="NHWC")
    port.initialize(tinit.MSRAPrelu(), device="cpu")
    t_std = float(port.weight.detach().std())
    mxnet_std = math.sqrt(2.0 / (1 + 0.25 ** 2) / (256 * 9))
    assert abs(t_std / mxnet_std - 1) < STD_RTOL
    j_nchw, j_nhwc = jax_std("NCHW"), jax_std("NHWC")
    assert abs(t_std / j_nchw - 1) < STD_RTOL
    ratio = math.sqrt((3 * 256 * 256) / (256 * 9))
    assert abs(j_nchw / j_nhwc / ratio - 1) < STD_RTOL, (j_nchw, j_nhwc)


@pytest.mark.parametrize("layout,conv", [
    ("NWC", lambda nn, layout: nn.Conv1D(64, 5, in_channels=32,
                                         layout=layout)),
    ("NDHWC", lambda nn, layout: nn.Conv3D(16, 3, in_channels=24,
                                           layout=layout)),
    ("NHWC", lambda nn, layout: nn.Conv2DTranspose(32, 4, in_channels=48,
                                                   layout=layout))])
def test_xavier_fans_follow_the_port_weight_in_every_layout(layout, conv):
    """(O, I/g, *k) (and a transposed (I, O/g, *k)) gives MXNet's fans in
    every rank: the port's std against the formula's."""
    blk = conv(tgluon.nn, layout)
    blk.initialize(tinit.Xavier("gaussian", "avg", 3), device="cpu")
    w = blk.weight.detach()
    hw = math.prod(w.shape[2:])
    std = math.sqrt(3.0 / ((w.shape[0] + w.shape[1]) * hw / 2.0))
    assert abs(float(w.std()) / std - 1) < 0.05, (float(w.std()), std)


def test_block_initialize_takes_every_initializer():
    """`net.initialize(init)` with the script initializers: weights drawn,
    biases zero, gamma one (the name dispatch), and a Parameter's own
    initializer wins."""
    for init in (tinit.Xavier(), tinit.MSRAPrelu(), tinit.Orthogonal(),
                 tinit.Mixed([".*"], [tinit.Normal(0.2)]), "xavier"):
        net = tgluon.nn.HybridSequential(
            tgluon.nn.Dense(16, in_units=8),
            tgluon.nn.Dense(4, in_units=16,
                            weight_initializer=tinit.Constant(0.25)),
            tgluon.nn.LayerNorm(in_channels=4))
        net.initialize(init, device="cpu")
        params = net.collect_params()
        assert float(params["0.weight"].data().detach().abs().sum()) > 0
        assert float(params["0.bias"].data().detach().abs().sum()) == 0
        assert torch.equal(params["1.weight"].data(),
                           torch.full((4, 16), 0.25))
        assert torch.equal(params["2.gamma"].data(), torch.ones(4))
