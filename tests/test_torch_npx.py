"""PyTorch port: every `mx.npx` name against the JAX package's on the CPU.

The same numpy inputs, made from a seed, go through
`incubator_mxnet_tpu.numpy_extension` and the port's; values, gradients
and result dtypes must agree (float32: rtol 1e-5 / atol 1e-5 unless a case
states more; the JAX fused ops run their Pallas kernels in interpret mode,
as tests/test_torch_fused_ops.py runs them). Also: the kernel ops reach the
kernels' plain versions on CPU arrays (the launch counters stay 0), the
control flow, the name left for later raises, `pick` takes `mode` (C18),
and AMP at dispatch gives
every registered name the JAX package's result dtype.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops import fused as jfused
from incubator_mxnet_tpu_torch.ops import kernels

from torch_port_utils import (assert_parity, jax_amp_restored, parity,
                              to_jax_args, to_port_args)

torch.set_num_threads(1)

CPU = tmx.cpu()
R = np.random.RandomState(0)
X = R.randn(2, 3, 4, 5).astype(np.float32)
X2 = R.randn(3, 6).astype(np.float32)
UNIT = R.uniform(-0.9, 0.9, (3, 6)).astype(np.float32)
POS = (np.abs(X2) + 0.5).astype(np.float32)
G3 = (1 + 0.2 * R.randn(3)).astype(np.float32)
B3 = (0.1 * R.randn(3)).astype(np.float32)
G6 = (1 + 0.2 * R.randn(6)).astype(np.float32)
B6 = (0.1 * R.randn(6)).astype(np.float32)
IDX = np.array([[0, 2, 5], [1, 1, 3], [4, 0, 2]], np.int32)
LENS = np.array([2, 3, 1], np.int32)
SEQ = R.randn(4, 3, 2).astype(np.float32)        # (T, N, C) time-major
W = R.randn(7, 6).astype(np.float32)
CW = (R.randn(4, 3, 3, 3) / 3).astype(np.float32)
CB = (0.1 * R.randn(4)).astype(np.float32)
DW = (R.randn(3, 2, 3, 3) / 3).astype(np.float32)
MASK = R.rand(3, 6) > 0.3
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(name, args, kw=None, tol=None, grad=False):
    return pytest.param(name, args, kw or {}, tol or TOL, grad, id=name)


CASES = [
    _case("relu", (X2,), grad=True), _case("sigmoid", (X2,), grad=True),
    _case("tanh", (X2,), grad=True), _case("erf", (X2,)),
    _case("erfinv", (UNIT,), tol=dict(rtol=1e-4, atol=1e-5)),
    _case("gamma", (POS,)), _case("gammaln", (POS,)),
    _case("digamma", (POS,), tol=dict(rtol=1e-4, atol=1e-5)),
    _case("softplus", (X2,)), _case("log_sigmoid", (X2,)),
    _case("silu", (X2,), grad=True), _case("swish", (X2,)),
    _case("stop_gradient", (X2,)), _case("gelu", (X2,), grad=True),
    _case("gelu", (X2,), {"approximate": True}), _case("elu", (X2,)),
    _case("selu", (X2,)),
    _case("leaky_relu", (X2,), {"slope": 0.1}, grad=True),
    _case("leaky_relu", (X2,), {"act_type": "elu", "slope": 0.5}),
    _case("leaky_relu", (X2,), {"act_type": "selu"}),
    _case("leaky_relu", (X2,), {"act_type": "gelu"}),
    _case("leaky_relu", (X2, G6), {"act_type": "prelu"}),
    _case("leaky_relu", (X2,), {"act_type": "rrelu"}),
    _case("activation", (X2,), {"act_type": "softrelu"}),
    _case("activation", (X2,), {"act_type": "softsign"}),
    _case("softmax", (X2,), {"axis": 0}, grad=True),
    _case("softmax", (X2,), {"temperature": 2.0}),
    _case("softmax", (X2,), {"length": LENS + 2}),
    _case("log_softmax", (X2,), {"temperature": 0.5}, grad=True),
    _case("masked_softmax", (X2, MASK), grad=True),
    _case("one_hot", (IDX,), {"depth": 6}),
    _case("one_hot", (IDX,), {"depth": 4, "on_value": 2.0,
                              "off_value": -1.0, "dtype": "int32"}),
    _case("pick", (X2, IDX[:, 0].copy()), grad=True),
    _case("pick", (X2, IDX[:, 1].copy()), {"axis": 1, "keepdims": True}),
    _case("topk", (X2,), {"k": 2}),
    _case("topk", (X2,), {"k": 3, "ret_typ": "both", "is_ascend": True}),
    _case("topk", (X2,), {"k": 1, "axis": 0, "ret_typ": "value"}),
    _case("sequence_mask", (SEQ,), {"sequence_length": LENS,
                                    "use_sequence_length": True,
                                    "value": -1.0}),
    _case("embedding", (IDX, W), grad=True),
    _case("layer_norm", (X2, G6, B6), grad=True),
    _case("group_norm", (X[:, :, :2].reshape(2, 3, 2, 5) * 1.0,
                         G3, B3), {"num_groups": 1}),
    _case("instance_norm", (X, G3, B3), grad=True),
    _case("rms_norm", (X2, G6), grad=True),
    _case("l2_normalization", (X2,), grad=True),
    _case("fully_connected", (X2, W, (0.1 * R.randn(7)).astype(np.float32)),
          grad=True),
    _case("convolution", (X.transpose(0, 1, 3, 2).copy() * 1.0, CW[:, :3],
                          CB), {"pad": 1}),
    _case("deconvolution", (X[:, :3], DW), {"stride": 2}),
    _case("pooling", (X,), {"kernel": 2, "stride": 2}),
    _case("pooling", (X,), {"kernel": 3, "pool_type": "avg", "pad": 1,
                            "stride": 1}),
    _case("pooling", (X,), {"global_pool": True, "pool_type": "avg"}),
    _case("smooth_l1", (X2,), {"scalar": 2.0}),
    _case("arange_like", (X2,), {"start": 1.0, "step": 0.5}),
    _case("arange_like", (X2,), {"axis": 1}),
    _case("broadcast_like", (X2[:1], X2)),
    _case("shape_array", (X,)),
    _case("scaled_dot_product_attention", (X, X * 0.5, X[:, :, ::-1].copy()),
          grad=True),
    _case("sequence_last", (SEQ,)),
    _case("sequence_last", (SEQ, LENS), {"use_sequence_length": True}),
    _case("sequence_reverse", (SEQ, LENS), {"use_sequence_length": True}),
    _case("sequence_reverse", (SEQ,)),
]


@pytest.mark.parametrize("name,args,kw,tol,grad", CASES)
def test_npx_name_matches_jax(name, args, kw, tol, grad):
    kw = dict(kw)
    jkw = {k: (jmx.np.array(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (tmx.np.array(v, device=CPU) if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()}
    jf = lambda *a: getattr(jmx.npx, name)(*a, **jkw)  # noqa: E731
    tf = lambda *a: getattr(tmx.npx, name)(*a, **tkw)  # noqa: E731
    parity(jf, tf, *args, grad=grad, **tol)


def test_batch_norm_writes_running_stats_as_jax():
    xs = X.transpose(0, 2, 3, 1).reshape(-1, 3).copy()
    for training in (False, True):
        jargs = to_jax_args([xs, G3, B3, 0.1 * B3, 1 + G3 * G3])
        targs = to_port_args([xs, G3, B3, 0.1 * B3, 1 + G3 * G3])
        for fused in (False, True):
            jn = "fused_batch_norm" if fused else "batch_norm"
            kw = dict(training=training, axis=-1, momentum=0.8)
            if fused:
                jfused._INTERPRET[0] = True
            try:
                jo = getattr(jmx.npx, jn)(*jargs, **kw)
            finally:
                jfused._INTERPRET[0] = None
            to = getattr(tmx.npx, jn)(*targs, **kw)
            assert_parity(to, jo, **TOL)
            assert_parity(targs[3], jargs[3], **TOL)
            assert_parity(targs[4], jargs[4], **TOL)


@pytest.fixture
def jax_interpret():
    """The JAX fused ops on their Pallas kernels in interpret mode."""
    jfused._INTERPRET[0] = True
    yield
    jfused._INTERPRET[0] = None


NHWC = R.randn(2, 4, 4, 8).astype(np.float32)
C8 = (1 + 0.2 * R.randn(8)).astype(np.float32)
S8 = (0.1 * R.randn(8)).astype(np.float32)


@pytest.mark.parametrize("name,args,kw", [
    ("fused_bias_act", (NHWC, S8), {"act_type": "relu"}),
    ("fused_bias_act", (NHWC, S8), {"act_type": "sigmoid"}),
    ("fused_norm_act_residual", (NHWC, C8, S8, NHWC[::-1].copy()),
     {"act_type": "relu"}),
    ("fused_bn_inference", (NHWC, C8, S8, 0.1 * S8, 1 + C8 * C8),
     {"act_type": "relu"}),
    ("fused_batch_norm", (NHWC, C8, S8, 0.1 * S8, 1 + C8 * C8),
     {"axis": -1, "act_type": "relu", "training": True}),
    ("fused_avg_pool2d", (NHWC,), {"pool_size": 2}),
    ("fused_avg_pool2d", (NHWC,), {"pool_size": (4, 4)}),
])
def test_fused_kernel_ops_match_jax_kernels(jax_interpret, name, args, kw):
    kernels.reset_launch_counts()
    jf = lambda *a: getattr(jmx.npx, name)(*a, **kw)   # noqa: E731
    tf = lambda *a: getattr(tmx.npx, name)(*a, **kw)   # noqa: E731
    parity(jf, tf, *args, grad=True, rtol=1e-5, atol=1e-5)
    # CPU arrays take the plain versions: no kernel launched
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_values_and_gradients_match_jax(causal):
    q = R.randn(4, 16, 8).astype(np.float32)
    k = R.randn(4, 16, 8).astype(np.float32)
    v = R.randn(4, 16, 8).astype(np.float32)
    kernels.reset_launch_counts()
    parity(lambda *a: jmx.npx.flash_attention(*a, causal=causal),
           lambda *a: tmx.npx.flash_attention(*a, causal=causal),
           q, k, v, grad=True, rtol=1e-5, atol=2e-5)
    # outside record() the forward records nothing
    out = tmx.npx.flash_attention(*to_port_args([q, k, v]), causal=causal)
    assert not out._t.requires_grad
    assert sum(kernels.launch_counts().values()) == 0


def _slab(kind):
    rng = np.random.RandomState(3)
    S, C, H, D, T, L = 3, 2, 2, 8, 12, 2     # slab (rows, L, T, H, D)
    q = rng.randn(S, C, H, D).astype(np.float32)
    lens = np.array([0, 5, 10], np.int32)
    if kind == "float":
        k = rng.randn(S + 1, L, T, H, D).astype(np.float32)
        v = rng.randn(S + 1, L, T, H, D).astype(np.float32)
        return (q, k, v, lens, 1), {}
    k = rng.randint(-127, 128, (S + 1, L, T, H, D)).astype(np.int8)
    v = rng.randint(-127, 128, (S + 1, L, T, H, D)).astype(np.int8)
    ks = (0.01 + 0.01 * rng.rand(S + 1, L, T)).astype(np.float32)
    vs = (0.01 + 0.01 * rng.rand(S + 1, L, T)).astype(np.float32)
    return (q, k, v, lens, 1), {"k_scale": ks, "v_scale": vs}


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_paged_attention_matches_jax_kernel(kind):
    args, sc = _slab(kind)
    want = jmx.npx.paged_attention(*to_jax_args(list(args)),
                                   **to_jax_args(sc), interpret=True)
    got = tmx.npx.paged_attention(*to_port_args(list(args)),
                                  **to_port_args(sc), interpret=True)
    assert_parity(got, want, rtol=2e-5, atol=2e-5)


def _boxes(n=12, b=2, seed=5):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 0.6
    wh = 0.1 + rng.rand(b, n, 2) * 0.3
    ids = rng.randint(0, 3, (b, n, 1)).astype(np.float32)
    score = rng.rand(b, n, 1)
    return np.concatenate([ids, score, xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"force_suppress": True},
                                {"topk": 5, "valid_thresh": 0.2}])
def test_box_nms_matches_jax(kw):
    parity(lambda d: jmx.npx.box_nms(d, overlap_thresh=0.3, **kw),
           lambda d: tmx.npx.box_nms(d, overlap_thresh=0.3, **kw),
           _boxes())


def test_box_iou_and_multibox_ops_match_jax():
    b = _boxes()
    parity(jmx.npx.box_iou, tmx.npx.box_iou, b[0, :5, 2:6].copy(),
           b[1, :4, 2:6].copy())
    feat = R.randn(1, 4, 3, 3).astype(np.float32)
    kw = dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0), steps=(0.3, 0.3))
    anchors = parity(lambda f: jmx.npx.multibox_prior(f, **kw),
                     lambda f: tmx.npx.multibox_prior(f, **kw), feat)
    A = anchors.shape[1]
    label = np.full((2, 3, 5), -1.0, np.float32)
    label[0, :2] = [[0, 0.1, 0.1, 0.4, 0.5], [2, 0.5, 0.4, 0.9, 0.8]]
    label[1, :1] = [[1, 0.2, 0.3, 0.6, 0.7]]
    cls_pred = R.randn(2, 4, A).astype(np.float32)
    an = anchors.asnumpy()
    parity(lambda a, l, c: jmx.npx.multibox_target(
        a, l, c, negative_mining_ratio=3.0),
        lambda a, l, c: tmx.npx.multibox_target(
            a, l, c, negative_mining_ratio=3.0), an, label, cls_pred)
    prob = np.exp(cls_pred) / np.exp(cls_pred).sum(1, keepdims=True)
    loc = (0.1 * R.randn(2, A * 4)).astype(np.float32)
    parity(lambda p, l, a: jmx.npx.multibox_detection(p, l, a,
                                                      nms_threshold=0.45),
           lambda p, l, a: tmx.npx.multibox_detection(p, l, a,
                                                      nms_threshold=0.45),
           prob.astype(np.float32), loc, an)


def test_multi_sum_sq_and_clip_by_global_norm_match_jax():
    parity(lambda *a: jmx.npx.multi_sum_sq(*a),
           lambda *a: tmx.npx.multi_sum_sq(*a), X2, G6, W)
    ja, ta = to_jax_args([X2, W]), to_port_args([X2, W])
    assert_parity(tmx.npx.clip_by_global_norm(ta, 1.0),
                  jmx.npx.clip_by_global_norm(ja, 1.0), **TOL)
    for g, w in zip(ta, ja):
        assert_parity(g, w, **TOL)


def test_dropout_draws_only_in_training():
    x = tmx.np.ones((200, 100), device=CPU)
    assert tmx.npx.dropout(x, p=0.3) is x
    tmx.seed(1)
    with tmx.autograd.train_mode():
        y = tmx.npx.dropout(x, p=0.3)
        z = tmx.npx.dropout(x, p=0.5, axes=(1,))
    kept = (y.asnumpy() > 0).mean()
    assert abs(kept - 0.7) < 0.02
    np.testing.assert_allclose(y.asnumpy()[y.asnumpy() > 0], 1 / 0.7,
                               rtol=1e-6)
    zn = z.asnumpy()
    assert (zn == zn[:1]).all()     # one mask draw along axis 0... per column
    j = jmx.npx.dropout(jmx.np.ones((4, 4)), p=0.3)
    assert str(j.dtype) == str(y.dtype)


def test_control_flow_matches_jax():
    data = R.randn(5, 3).astype(np.float32)
    init = np.zeros(3, np.float32)

    def body(pkg):
        return lambda x, s: (x * 2 + s, s + x)

    for single in (True, False):
        jd, td = to_jax_args([data, init]), to_port_args([data, init])
        if single:
            jo, js = jmx.npx.foreach(body(jmx), jd[0], jd[1])
            to, ts = tmx.npx.foreach(body(tmx), td[0], td[1])
        else:
            jo, js = jmx.npx.foreach(
                lambda xs, ss: ([xs[0] + ss[0]], [ss[0] * 0.5 + xs[0]]),
                [jd[0]], [jd[1]])
            to, ts = tmx.npx.foreach(
                lambda xs, ss: ([xs[0] + ss[0]], [ss[0] * 0.5 + xs[0]]),
                [td[0]], [td[1]])
        assert_parity(to, jo, **TOL)
        assert_parity(ts, js, **TOL)
    # differentiable through the loop
    parity(lambda d, s: jmx.npx.foreach(body(jmx), d, s)[0],
           lambda d, s: tmx.npx.foreach(body(tmx), d, s)[0], data, init,
           grad=True, **TOL)
    jw = jmx.npx.while_loop(lambda i, s: i < 5, lambda i, s: (i + 1, s * 2),
                            [jmx.np.array(0), jmx.np.array(1.0)],
                            max_iterations=10)
    tw = tmx.npx.while_loop(lambda i, s: i < 5, lambda i, s: (i + 1, s * 2),
                            [tmx.np.array(0, device=CPU),
                             tmx.np.array(1.0, device=CPU)],
                            max_iterations=10)
    assert tw[0] == jw[0] == []
    assert_parity(tw[1], jw[1])
    for p in (1.0, -1.0):
        args = [np.float32(p) * X2]
        jc = jmx.npx.cond(lambda x: x.sum() > 0, lambda x: x * 2,
                          lambda x: x - 1, to_jax_args(args))
        tc = tmx.npx.cond(lambda x: x.sum() > 0, lambda x: x * 2,
                          lambda x: x - 1, to_port_args(args))
        assert_parity(tc, jc, **TOL)
    assert tmx.npx.scan is tmx.npx.foreach


def test_np_mode_scopes_and_io(tmp_path):
    tmx.npx.set_np()
    assert tmx.npx.is_np_array() and tmx.npx.is_np_shape()
    tmx.npx.reset_np()
    f = lambda x: x                                   # noqa: E731
    assert tmx.npx.use_np(f) is f
    path = str(tmp_path / "a.npz")
    tmx.npx.save(path, [tmx.np.array(X2, device=CPU)])
    with tmx.cpu():
        back = tmx.npx.load(path)
    np.testing.assert_array_equal(back[0].asnumpy(), X2)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_pick_takes_mode_and_clips_as_jax(mode, axis):
    """C18: `npx.pick(..., mode=)` is the JAX package's signature; both
    packages clip an out-of-range index in every mode."""
    idx = np.array([-3, 7, 2] if axis == -1 else [9, -1, 12], np.int32)
    x = X2 if axis == -1 else X2.T.copy()
    want = jmx.npx.pick(jmx.np.array(x), jmx.np.array(idx), axis=axis,
                        mode=mode)
    got = tmx.npx.pick(tmx.np.array(x, device=CPU),
                       tmx.np.array(idx, device=CPU), axis=axis, mode=mode)
    assert_parity(got, want, rtol=0, atol=0)


def test_every_jax_npx_name_is_exported_and_cased():
    assert set(jmx.npx.__all__) <= set(tmx.npx.__all__)
    cased = {c.values[0] for c in CASES} | {
        "batch_norm", "fused_batch_norm", "fused_bias_act",
        "fused_norm_act_residual", "fused_bn_inference", "fused_avg_pool2d",
        "flash_attention", "paged_attention", "box_nms", "box_iou",
        "multibox_prior", "multibox_target", "multibox_detection",
        "multi_sum_sq", "clip_by_global_norm", "dropout", "foreach",
        "while_loop", "cond", "scan", "set_np", "reset_np", "is_np_array",
        "is_np_shape", "use_np", "roi_align", "bilinear_resize2d",
        "proposal", "deformable_convolution", "psroi_pooling", "rnn",
        "fused_image_augment"}
    assert set(jmx.npx.__all__) <= cased, sorted(set(jmx.npx.__all__)
                                                - cased)


# ---------------------------------------------------------------------------
# AMP at dispatch
# ---------------------------------------------------------------------------
@pytest.fixture
def amp_bf16():
    with jax_amp_restored():
        jmx.amp.init("bfloat16")
        tmx.amp.init("bfloat16")
        yield
        jmx.amp.uninit()
        tmx.amp.uninit()


def test_amp_casts_by_op_name_as_jax(amp_bf16):
    a, b = X2, W.T.copy()
    checks = [
        ("np.matmul", lambda m, x, y: m.np.matmul(x, y), (a, b)),
        ("np.sum", lambda m, x: m.np.sum(x), (a,)),
        ("np.add", lambda m, x, y: m.np.add(x, y), (a, a)),
        ("np.exp", lambda m, x: m.np.exp(x), (a,)),
        ("np.tanh", lambda m, x: m.np.tanh(x), (a,)),
        ("x + 1.0", lambda m, x: x + 1.0, (a,)),
        ("x.mean()", lambda m, x: x.mean(), (a,)),
        ("x.reshape", lambda m, x: x.reshape(-1), (a,)),
        ("npx.softmax", lambda m, x: m.npx.softmax(x), (a,)),
        ("npx.layer_norm", lambda m, x, g, b: m.npx.layer_norm(x, g, b),
         (a, G6, B6)),
        ("npx.relu", lambda m, x: m.npx.relu(x), (a,)),
        ("npx.fully_connected", lambda m, x, w: m.npx.fully_connected(
            x, w, no_bias=True), (a, W)),
        ("npx.l2_normalization", lambda m, x: m.npx.l2_normalization(x),
         (a,)),
        ("npx.flash_attention", lambda m, q, k, v: m.npx.flash_attention(
            q, k, v), (SEQ, SEQ, SEQ)),
        ("npx.pooling", lambda m, x: m.npx.pooling(x, kernel=2, stride=2),
         (X,)),
        ("npx.box_iou", lambda m, x, y: m.npx.box_iou(x, y),
         (_boxes()[0, :4, 2:6].copy(), _boxes()[1, :3, 2:6].copy())),
    ]
    for what, f, args in checks:
        j = f(jmx, *to_jax_args(list(args)))
        t = f(tmx, *to_port_args(list(args)))
        assert str(t.dtype) == str(j.dtype), (what, t.dtype, j.dtype)
        np.testing.assert_allclose(
            t.asnumpy(), np.asarray(j.asnumpy(), np.float32),
            rtol=2e-2, atol=2e-2, err_msg=what)
    # a float32 array reaches flash as bf16 (the "safe" class)
    seen = []
    orig = tmx.ops.attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return orig(q, k, v, **kw)

    import incubator_mxnet_tpu_torch.numpy_extension as tnpx
    tnpx._attention.flash_attention = spy
    try:
        tmx.npx.flash_attention(*to_port_args([SEQ, SEQ, SEQ]))
    finally:
        tnpx._attention.flash_attention = orig
    assert seen == [torch.bfloat16]


def _np_amp_names():
    from test_torch_np_ops import CASES as NP
    return sorted(n for n, c in NP.items()
                  if any(isinstance(a, np.ndarray) and a.dtype == np.float32
                         for a in c[0]))


@pytest.mark.parametrize("name", _np_amp_names())
def test_amp_result_dtype_of_every_np_name_matches_jax(amp_bf16, name):
    from test_torch_np_ops import CASES as NP
    args, kw = NP[name][0], NP[name][1]
    want = getattr(jmx.np, name)(*to_jax_args(args), **kw)
    with tmx.cpu():
        got = getattr(tmx.np, name)(*to_port_args(args), **kw)

    def dtypes(o):
        if isinstance(o, (list, tuple)):
            return [dtypes(v) for v in o]
        return str(getattr(o, "dtype", type(o).__name__))
    assert dtypes(got) == dtypes(want)
