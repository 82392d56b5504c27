"""PyTorch port: the `gluon.nn` layers of the Gluon script surface, and
`Block` with its hooks, against the JAX package.

Each layer is built in both packages with the same arguments; the JAX
block's values are set from numpy (made from a seed: varied gammas, betas,
biases and PReLU slopes, weights scaled by 1/sqrt(fan-in)) and carried into
the port block with `gluon.params_from_jax`, which converts every
convolution weight layout (channels-last weights are kernel dims first in
the JAX package). The same numpy input goes through both; the output, the
input's gradient and every Parameter's gradient (the JAX package's
`record` + `backward`, torch autograd, both seeded with ones) must agree.
float32 on both sides: 2e-5 relative + 2e-5 absolute (XLA's and PyTorch's
CPU convolutions and reductions sum in other orders).

The fused routing of the convolutions follows the JAX package's gate:
inside a fusion scope a convolution with a bias and relu takes the fused
bias-activation op, whose kernel (B1) runs only with the channel axis
last. The port's plain version of B1 (`ops.fused.apply_ref`, what its
wrapper runs on the CPU) must be called exactly for the channels-last
layouts, and the outputs must match the JAX package's with its Pallas
kernel in interpret mode.
"""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.ops import fused as jfused

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.ops import fused as tfused

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-5


def _value(name, shape, rng):
    if name.endswith("gamma"):
        return 1.0 + 0.2 * rng.randn(*shape)
    if name.endswith("beta") or name.endswith("bias"):
        return 0.1 * rng.randn(*shape)
    if name.endswith("alpha"):
        return 0.25 + 0.1 * rng.randn(*shape)
    fan = max(int(np.prod(shape)) // max(shape[0], 1), 1)
    return rng.randn(*shape) / math.sqrt(fan)


def pair(make, x, seed=0):
    """(JAX block, port block) built by `make(nn)`, holding the same
    values; the JAX block's deferred shapes resolve on `x`."""
    jblk = make(jgluon.nn)
    jblk.initialize()
    jblk(mx.np.array(x))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in sorted(jblk.collect_params().items()):
        v = _value(name, p.shape, rng).astype(np.float32)
        p.set_data(mx.np.array(v))
        values[name] = v
    tblk = make(tgluon.nn).initialize(device="cpu")
    if values:
        tgluon.params_from_jax(tblk, values)
    return jblk, tblk


def run_jax(jblk, x):
    xj = mx.np.array(x)
    xj.attach_grad()
    with mx.autograd.record():
        out = jblk(xj)
    out.backward()
    grads = {n: p.grad().asnumpy()
             for n, p in jblk.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xj.grad.asnumpy(), grads


def run_port(tblk, x):
    xt = torch.tensor(x, requires_grad=True)
    with tautograd.record():
        out = tblk(xt)
    out.backward(torch.ones_like(out))
    grads = {n: tblk._file_layout(n, p.data().grad)
             for n, p in tblk.collect_params().items()
             if p.grad_req != "null"}
    return out.detach().numpy(), xt.grad.numpy(), grads


def assert_matches(jblk, tblk, x, rtol=RTOL, atol=ATOL):
    jo, jx, jg = run_jax(jblk, x)
    to, tx, tg = run_port(tblk, x)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, rtol=rtol, atol=atol,
                               err_msg="output")
    np.testing.assert_allclose(tx, jx, rtol=rtol, atol=atol,
                               err_msg="input gradient")
    assert sorted(tg) == sorted(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], rtol=rtol, atol=atol,
                                   err_msg=f"gradient of {name}")


def _input(layout, spatial, channels=4, seed=1):
    """NC* / N*C data of `spatial` dims."""
    rng = np.random.RandomState(seed)
    shape = (2, channels) + spatial if layout.startswith("NC") \
        else (2,) + spatial + (channels,)
    return rng.randn(*shape).astype(np.float32)


SPATIAL = {1: (9,), 2: (7, 6), 3: (5, 6, 4)}
LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
CONVS = {
    "conv_plain": lambda nn, k, lay: k(6, 3, layout=lay),
    "conv_strided_grouped": lambda nn, k, lay: k(
        6, 3, strides=2, padding=1, dilation=1, groups=2, layout=lay,
        activation="tanh"),
    "conv_dilated_nobias": lambda nn, k, lay: k(
        4, 2, padding=2, dilation=2, use_bias=False, layout=lay),
    "deconv_plain": lambda nn, k, lay: k(5, 3, layout=lay,
                                         in_channels=4),
    "deconv_strided": lambda nn, k, lay: k(
        6, 3, strides=2, padding=1, output_padding=1, groups=2,
        layout=lay, activation="relu"),
    "deconv_dilated": lambda nn, k, lay: k(
        4, 2, strides=2, dilation=2, use_bias=False, layout=lay),
}


def _conv_class(nn, nd, kind):
    name = f"Conv{nd}D" + ("Transpose" if kind.startswith("deconv") else "")
    return getattr(nn, name)


@pytest.mark.parametrize("layout_i", [0, 1], ids=["channels_first",
                                                   "channels_last"])
@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(CONVS))
def test_convolutions_match_jax(kind, nd, layout_i):
    layout = LAYOUTS[nd][layout_i]
    x = _input(layout, SPATIAL[nd])

    def make(nn):
        return CONVS[kind](nn, _conv_class(nn, nd, kind), layout)
    jblk, tblk = pair(make, x)
    assert_matches(jblk, tblk, x)


POOLS = {
    "max": lambda nn, nd, lay: getattr(nn, f"MaxPool{nd}D")(
        2, layout=lay),
    "max_padded_ceil": lambda nn, nd, lay: getattr(nn, f"MaxPool{nd}D")(
        3, 2, 1, layout=lay, ceil_mode=True),
    "avg": lambda nn, nd, lay: getattr(nn, f"AvgPool{nd}D")(
        2, layout=lay),
    "avg_padded_exclusive": lambda nn, nd, lay: getattr(
        nn, f"AvgPool{nd}D")(3, 2, 1, layout=lay, ceil_mode=True,
                             count_include_pad=False),
    "avg_padded_inclusive": lambda nn, nd, lay: getattr(
        nn, f"AvgPool{nd}D")(3, 1, 1, layout=lay),
    "global_max": lambda nn, nd, lay: getattr(
        nn, f"GlobalMaxPool{nd}D")(layout=lay),
    "global_avg": lambda nn, nd, lay: getattr(
        nn, f"GlobalAvgPool{nd}D")(layout=lay),
}


@pytest.mark.parametrize("layout_i", [0, 1], ids=["channels_first",
                                                   "channels_last"])
@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(POOLS))
def test_pools_match_jax(kind, nd, layout_i):
    layout = LAYOUTS[nd][layout_i]
    x = _input(layout, SPATIAL[nd])
    jblk, tblk = pair(lambda nn: POOLS[kind](nn, nd, layout), x)
    assert_matches(jblk, tblk, x)


LAYERS = {
    "layer_norm_axis1": (lambda nn: nn.LayerNorm(axis=1, epsilon=1e-3),
                         (2, 5, 3)),
    "layer_norm_frozen": (lambda nn: nn.LayerNorm(center=False, scale=False,
                                                  in_channels=6), (3, 6)),
    "group_norm": (lambda nn: nn.GroupNorm(num_groups=2, epsilon=1e-4),
                   (2, 6, 3, 4)),
    "instance_norm": (lambda nn: nn.InstanceNorm(), (2, 3, 5, 4)),
    "rms_norm": (lambda nn: nn.RMSNorm(epsilon=1e-5), (3, 4, 8)),
    "leaky_relu": (lambda nn: nn.LeakyReLU(0.1), (3, 7)),
    "prelu": (lambda nn: nn.PReLU(in_channels=7), (3, 7)),
    "prelu_shared": (lambda nn: nn.PReLU(), (2, 3, 4)),
    "elu": (lambda nn: nn.ELU(0.7), (3, 7)),
    "selu": (lambda nn: nn.SELU(), (3, 7)),
    "gelu_erf": (lambda nn: nn.GELU(), (3, 7)),
    "gelu_tanh": (lambda nn: nn.GELU(approximation="tanh"), (3, 7)),
    "swish": (lambda nn: nn.Swish(), (3, 7)),
    "swish_beta": (lambda nn: nn.Swish(beta=2.0), (3, 7)),
    "silu": (lambda nn: nn.SiLU(), (3, 7)),
    "identity": (lambda nn: nn.Identity(), (3, 7)),
    "hybrid_lambda": (lambda nn: nn.HybridLambda("tanh"), (3, 7)),
    "reflection_pad": (lambda nn: nn.ReflectionPad2D((1, 2, 2, 1)),
                       (2, 3, 5, 4)),
    "sequential": (lambda nn: nn.Sequential(nn.Dense(5, in_units=7),
                                            nn.ELU()), (3, 7)),
    "hybrid_sequential_slice": (lambda nn: nn.HybridSequential(
        nn.Dense(5, activation="tanh"), nn.Dense(4), nn.GELU())[0:2],
        (3, 7)),
    "concatenate": (lambda nn: _concat(nn, nn.Concatenate(axis=1)),
                    (3, 7)),
    "hybrid_concatenate": (lambda nn: _concat(nn, nn.HybridConcatenate()),
                           (3, 7)),
}
for _act in ("relu", "sigmoid", "tanh", "softrelu", "softsign",
             "log_sigmoid", "mish"):
    LAYERS[f"activation_{_act}"] = (
        lambda nn, a=_act: nn.Activation(a), (3, 7))


def _concat(nn, blk):
    blk.add(nn.Dense(3, in_units=7), nn.Identity(), nn.Dense(2))
    return blk


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layers_match_jax(kind):
    make, shape = LAYERS[kind]
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jblk, tblk = pair(make, x)
    assert_matches(jblk, tblk, x)


def test_lambda_takes_a_callable_and_runs_several_inputs():
    blk = tgluon.nn.Lambda(lambda a, b: a * b + 1)
    a, b = torch.randn(3), torch.randn(3)
    assert torch.equal(blk(a, b), a * b + 1)
    assert isinstance(blk, tgluon.Block)
    assert not isinstance(blk, tgluon.HybridBlock)


def _count_plain_apply(monkeypatch):
    calls = []
    orig = tfused.apply_ref

    def counting(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)
    monkeypatch.setattr(tfused, "apply_ref", counting)
    return calls


@pytest.mark.parametrize("layout", ["NCW", "NWC", "NCDHW", "NDHWC",
                                    "NCHW", "NHWC"])
def test_fused_routing_of_convolutions_follows_jax(layout, monkeypatch):
    """In a fusion scope, relu with a bias: the plain version of B1 runs
    exactly for the channels-last layouts (over the (M, C) view), the
    channels-first ones stay plain, and every layout matches the JAX
    package's fused forward and backward (its kernel in interpret
    mode)."""
    nd = len(layout) - 2
    x = _input(layout, SPATIAL[nd])

    def make(nn):
        return _conv_class(nn, nd, "conv")(6, 3, padding=1,
                                           activation="relu", layout=layout)
    jblk, tblk = pair(make, x)
    calls = _count_plain_apply(monkeypatch)
    prev = jfused.set_interpret(True)
    try:
        with jfused.fusion_scope(True):
            jo, jx, jg = run_jax(jblk, x)
    finally:
        jfused.set_interpret(prev)
    with tfused.fusion_scope(True):
        to, tx, tg = run_port(tblk, x)
    if layout.startswith("NC"):
        assert calls == []
    else:
        m = 2 * math.prod(SPATIAL[nd])
        assert calls == [torch.Size([m, 6])]
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx, jx, rtol=RTOL, atol=ATOL)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], rtol=RTOL, atol=ATOL)


def test_unknown_layout_is_refused():
    with pytest.raises(MXNetError, match="layout"):
        tgluon.nn.Conv2D(4, 3, layout="HWNC")


# ---------------------------------------------------------------------------
# Block and its hooks
# ---------------------------------------------------------------------------
def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=5, activation="relu"))
    inner = nn.HybridSequential()
    inner.add(nn.Dense(4, in_units=8), nn.Activation("tanh"))
    net.add(inner)
    net.add(nn.Dense(3, in_units=4))
    return net


def _hook_events(net, x, detach_after_first):
    events = []
    handles = []
    for blk in _walk(net):
        name = type(blk).__name__ + str(id(blk) % 997)
        pre = blk.register_forward_pre_hook(
            lambda b, args, n=name: events.append(("pre", type(b).__name__,
                                                   len(args))))
        post = blk.register_forward_hook(
            lambda b, args, out, n=name: events.append(
                ("post", type(b).__name__, tuple(out.shape))))
        handles += [pre, post]
    net(x)
    if detach_after_first:
        for h in handles[::2]:
            h.detach()
        net(x)
    return events


def _walk(blk):
    yield blk
    kids = blk._children.values() if hasattr(blk, "_children") and \
        not isinstance(blk, torch.nn.Module) else blk.children()
    for c in kids:
        yield from _walk(c)


@pytest.mark.parametrize("detach", [False, True])
def test_hooks_fire_in_the_jax_packages_order_and_detach(detach):
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    jnet = _net(jgluon.nn)
    jnet.initialize()
    tnet = _net(tgluon.nn).initialize(device="cpu")
    want = _hook_events(jnet, mx.np.array(x), detach)
    got = _hook_events(tnet, torch.tensor(x), detach)
    assert got == want
    assert ("pre", "HybridSequential", 1) == got[0]


def test_hook_handles_are_torch_handles_and_torch_tools_see_them():
    """The handle is torch's RemovableHandle with `detach()`; torch's hook
    options (prepend, with_kwargs) and the global module hooks still
    work."""
    blk = tgluon.nn.Dense(3, in_units=2).initialize(device="cpu")
    order = []
    h1 = blk.register_forward_hook(lambda b, a, o: order.append("first"))
    h2 = blk.register_forward_hook(lambda b, a, o: order.append("prepended"),
                                   prepend=True)
    h3 = blk.register_forward_pre_hook(
        lambda b, a, kw: order.append(("kwargs", sorted(kw))),
        with_kwargs=True)
    assert all(isinstance(h, torch.utils.hooks.RemovableHandle)
               for h in (h1, h2, h3))
    assert h1.id in blk._forward_hooks
    seen = []
    g = torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: seen.append(type(m).__name__))
    try:
        blk(torch.ones(1, 2))
    finally:
        g.remove()
    assert order == [("kwargs", []), "prepended", "first"]
    assert seen == ["Dense"]
    h1.detach()
    h2.remove()
    with h3:
        pass
    assert not blk._forward_hooks and not blk._forward_pre_hooks


def test_apply_visits_children_first_as_jax():
    jnet = _net(jgluon.nn)
    tnet = _net(tgluon.nn)
    jseen, tseen = [], []
    assert jnet.apply(lambda b: jseen.append(type(b).__name__)) is jnet
    assert tnet.apply(lambda b: tseen.append(type(b).__name__)) is tnet
    assert tseen == jseen


def test_summary_text_matches_jax(capsys):
    x = np.ones((2, 5), np.float32)
    jnet = _net(jgluon.nn)
    jnet.initialize()
    tnet = _net(tgluon.nn).initialize(device="cpu")
    want = jnet.summary(mx.np.array(x))
    got = tnet.summary(torch.tensor(x))
    assert got == want
    assert "Total params" in capsys.readouterr().out
    # the hooks summary registered are gone
    assert not any(m._forward_hooks for m in tnet.modules())


def test_params_register_child_and_reset_ctx():
    jd, td = jgluon.nn.Dense(3, in_units=2), tgluon.nn.Dense(3, in_units=2)
    assert sorted(td.params) == sorted(jd.params) == ["bias", "weight"]
    assert td.params["weight"] is td.collect_params()["weight"]

    class Net(tgluon.Block):
        def __init__(self):
            super().__init__()
            self.register_child(tgluon.nn.Dense(4, in_units=2))
            self.register_block(tgluon.nn.Dense(2, in_units=4), "head")

        def forward(self, x):
            return self._modules["head"](self._modules["0"](x))
    net = Net().initialize(device="cpu")
    assert sorted(net.collect_params()) == ["0.bias", "0.weight",
                                            "head.bias", "head.weight"]
    assert net.params == {}
    net.reset_ctx("cpu")
    assert net(torch.ones(1, 2)).shape == (1, 2)
    assert isinstance(tgluon.nn.Dense(1), tgluon.HybridBlock)
    assert issubclass(tgluon.HybridBlock, tgluon.Block)
