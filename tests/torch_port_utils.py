"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py): one
set of decoder weights, made with numpy from a seed, handed to both the
JAX package and the port.

The weight scales differ from `init_decoder_params` on purpose: with the
default init a small random decoder just repeats the prompt's last token,
which would make token-exact comparisons say little. These scales give
varied greedy streams.
"""
import contextlib

import numpy as np

CFG = dict(vocab=64, embed=32, layers=2, heads=4, head_dim=8, max_len=48)


def numpy_params(cfg=CFG, seed=0):
    """Decoder params in the packages' layer-stacked layout, float32."""
    rng = np.random.RandomState(seed)
    E, L, V = cfg["embed"], cfg["layers"], cfg["vocab"]
    M = cfg.get("mlp_hidden", 4 * E)

    def rnd(shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    out = {"emb": rnd((V, E), 0.1), "pos": rnd((cfg["max_len"], E), 0.5)}
    for name in ("wq", "wk", "wv", "wo"):
        out[name] = rnd((L, E, E), 3.0 / np.sqrt(E))
    out["w1"] = rnd((L, E, M), 3.0 / np.sqrt(E))
    out["w2"] = rnd((L, M, E), 3.0 / np.sqrt(M))
    out["ln1"] = np.ones((L, E), np.float32)
    out["ln2"] = np.ones((L, E), np.float32)
    out["lnf"] = np.ones((E,), np.float32)
    return out


def decoders(cfg=CFG, seed=0):
    """(JAX CachedDecoder, port CachedDecoder on the CPU) over the same
    weights."""
    import jax.numpy as jnp
    from incubator_mxnet_tpu import serve as jserve
    from incubator_mxnet_tpu_torch import serve as tserve
    pn = numpy_params(cfg, seed)
    jm = jserve.CachedDecoder(jserve.DecoderConfig(**cfg),
                              params={k: jnp.asarray(v)
                                      for k, v in pn.items()})
    tm = tserve.CachedDecoder(tserve.DecoderConfig(**cfg),
                              params=tserve.params_from_jax(pn, "cpu"),
                              device="cpu")
    return jm, tm


# ---------------------------------------------------------------------------
# ResNet training: one small BottleneckV1 ResNet in both packages, with the
# same numpy-made values
# ---------------------------------------------------------------------------
RESNET = dict(layers=[1, 1], channels=[8, 16, 32], classes=10)


def _resnet_value(name, shape, rng):
    """A numpy value for one parameter: varied BN affines and stats (not
    the ones/zeros init) so every term of the BN gradient counts."""
    if name.endswith("gamma"):
        return 1.0 + 0.2 * rng.randn(*shape)
    if name.endswith("beta") or name.endswith("bias"):
        return 0.1 * rng.randn(*shape)
    if name.endswith("running_mean"):
        return 0.1 * rng.randn(*shape)
    if name.endswith("running_var"):
        return 1.0 + 0.2 * np.abs(rng.randn(*shape))
    fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[1]
    return rng.randn(*shape) * np.sqrt(2.0 / fan_in)


def resnet_pair(thumbnail, seed=0):
    """(JAX net, port net on the CPU) — `ResNetV1(BottleneckV1, [1, 1],
    [8, 16, 32], classes=10, layout="NHWC")`, thumbnail stem (8x8 input)
    or the full stem (conv7 s2, BN, relu, maxpool; 32x32 input) — holding
    the same values, made with numpy from `seed` and carried into the port
    with `gluon.params_from_jax`."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    from incubator_mxnet_tpu_torch import gluon as tgluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    hw = 8 if thumbnail else 32
    jnet = jvision.ResNetV1(jvision.BottleneckV1, thumbnail=thumbnail,
                            layout="NHWC", **RESNET)
    jnet.initialize()
    jnet(mx.np.zeros((2, hw, hw, 3)))          # resolve deferred shapes
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        v = _resnet_value(name, p.shape, rng).astype(np.float32)
        p.set_data(mx.np.array(v))
        values[name] = v
    tnet = tvision.ResNetV1(tvision.BottleneckV1, thumbnail=thumbnail,
                            layout="NHWC", **RESNET).initialize(device="cpu")
    tgluon.params_from_jax(tnet, values)
    return jnet, tnet


def resnet_batch(thumbnail, seed=1, batch=4):
    """(images NHWC float32, int32 labels) made with numpy."""
    hw = 8 if thumbnail else 32
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, RESNET["classes"], size=batch).astype(np.int32)
    return x, y


def jax_values(jnet):
    return {n: np.asarray(p.data().asnumpy(), np.float32)
            for n, p in jnet.collect_params().items()}


def port_values(tnet):
    """The port net's values in the JAX package's layout (a channels-last
    convolution's weight back to kernel dims first), float32."""
    return {name: tnet._file_layout(name, p.data().float())
            for name, p in tnet.collect_params().items()}


def vision_pair(make, x_shape, seed=0):
    """(JAX net, port net on the CPU) built by `make(vision module)`,
    holding the same values made with numpy from `seed` (the JAX net's
    deferred shapes resolve on zeros of `x_shape`), carried into the port
    with `gluon.params_from_jax`."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    from incubator_mxnet_tpu_torch import gluon as tgluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    jnet = make(jvision)
    jnet.initialize()
    jnet(mx.np.zeros(x_shape))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        v = _resnet_value(name, p.shape, rng).astype(np.float32)
        p.set_data(mx.np.array(v))
        values[name] = v
    tnet = make(tvision).initialize(device="cpu")
    tgluon.params_from_jax(tnet, values)
    return jnet, tnet


def assert_values_close(got, want, rtol, atol, what=""):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# Transformer blocks: the same numpy values in a JAX block and a port block
# ---------------------------------------------------------------------------
TRANSFORMER = dict(units=32, heads=4, hidden=64, seq=16, vocab=50)


def _transformer_value(name, shape, rng):
    """Varied LayerNorm affines and biases (not the ones/zeros init), and
    weights scaled by 1/sqrt(fan-in), so every term of the gradient
    counts."""
    if name.endswith("gamma"):
        return 1.0 + 0.2 * rng.randn(*shape)
    if name.endswith("beta") or name.endswith("bias"):
        return 0.1 * rng.randn(*shape)
    return rng.randn(*shape) / np.sqrt(shape[-1])


def carry_values(jblk, tblk, seed=0):
    """Give the initialized JAX block numpy values made from `seed` and
    carry them into the port block with `gluon.params_from_jax`."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu_torch import gluon as tgluon
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in sorted(jblk.collect_params().items()):
        v = _transformer_value(name, p.shape, rng).astype(np.float32)
        p.set_data(mx.np.array(v))
        values[name] = v
    tgluon.params_from_jax(tblk, values)
    return values


def encoder_lm_pair(layers=2, use_flash=True, seed=0, cfg=TRANSFORMER,
                    deferred=False):
    """(JAX net, port net on the CPU): token embedding, positional
    embedding, `layers` pre-norm encoder cells (gelu, dropout 0), a final
    LayerNorm and a Dense head over the vocabulary — BERT's layout at a
    small width — holding the same values. `deferred`: the LayerNorm and
    the head are built without channel counts (their shapes resolve when
    the values are carried in)."""
    from incubator_mxnet_tpu import gluon as jgluon
    from incubator_mxnet_tpu_torch import gluon as tgluon

    def build(gluon, seq_add):
        nn = gluon.nn
        u, V = cfg["units"], cfg["vocab"]

        class EncoderLM(gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(V, u)
                self.pos = nn.PositionalEmbedding(cfg["seq"], u)
                self.cells = nn.HybridSequential()
                seq_add(self.cells, [nn.TransformerEncoderCell(
                    u, cfg["hidden"], cfg["heads"], dropout=0.0,
                    use_flash=use_flash) for _ in range(layers)])
                width = {} if deferred else {"in_channels": u}
                self.ln = nn.LayerNorm(**width)
                self.head = nn.Dense(V, flatten=False,
                                     in_units=0 if deferred else u)

            def forward(self, x):
                return self.head(self.ln(self.cells(self.pos(self.emb(x)))))
        return EncoderLM()

    jnet = build(jgluon, lambda s, cells: [s.add(c) for c in cells])
    jnet.initialize()
    if deferred:
        import incubator_mxnet_tpu as mx
        jnet(mx.np.zeros((1, cfg["seq"]), dtype="int32"))
    tnet = build(tgluon, lambda s, cells: s.add(*cells)).initialize(
        device="cpu")
    carry_values(jnet, tnet, seed)
    return jnet, tnet


def token_batch(seed=1, batch=2, cfg=TRANSFORMER):
    """(token ids, labels), (batch, seq) int32 from numpy."""
    rng = np.random.RandomState(seed)
    shape = (batch, cfg["seq"])
    return (rng.randint(0, cfg["vocab"], size=shape).astype(np.int32),
            rng.randint(0, cfg["vocab"], size=shape).astype(np.int32))


# ---------------------------------------------------------------------------
# parity: a JAX callable and a port callable on the same numpy inputs
# ---------------------------------------------------------------------------
# per-dtype tolerances (rtol, atol) of a value computed by both packages
PARITY_TOL = {"float32": (1e-5, 1e-6), "float16": (2e-3, 1e-3),
              "bfloat16": (1.6e-2, 1e-2)}


def to_jax_args(obj):
    """numpy arrays anywhere in `obj` (lists, tuples, dicts) as the JAX
    package's NDArrays."""
    import incubator_mxnet_tpu as jmx
    if isinstance(obj, np.ndarray):
        return jmx.np.array(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_jax_args(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_jax_args(v) for k, v in obj.items()}
    return obj


def to_port_args(obj):
    """numpy arrays anywhere in `obj` as the port's NDArrays on the CPU."""
    import incubator_mxnet_tpu_torch as tmx
    if isinstance(obj, np.ndarray):
        return tmx.np.array(obj, device=tmx.cpu())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port_args(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_port_args(v) for k, v in obj.items()}
    return obj


def assert_parity(got, want, rtol=None, atol=None, where="out"):
    """The port's result `got` equals the JAX package's `want`: the same
    structure, each array of the same shape and dtype name and within the
    dtype's tolerance (or rtol / atol), each dtype and scalar equal."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), (where, type(got))
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_parity(g, w, rtol, atol, f"{where}[{i}]")
        return
    if hasattr(want, "asnumpy") or hasattr(want, "__array__") and hasattr(
            want, "dtype") and not isinstance(want, np.dtype):
        wn = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
        assert hasattr(got, "asnumpy"), (where, type(got), wn)
        assert str(got.dtype) == str(want.dtype), (where, got.dtype,
                                                   want.dtype)
        gn = got.asnumpy()
        assert gn.shape == wn.shape, (where, gn.shape, wn.shape)
        r, a = PARITY_TOL.get(str(want.dtype), (1e-5, 1e-6))
        if wn.dtype.kind in "fc" or str(want.dtype) == "bfloat16":
            np.testing.assert_allclose(
                gn.astype(np.complex128 if gn.dtype.kind == "c"
                          else np.float64),
                np.asarray(wn, np.complex128 if wn.dtype.kind == "c"
                           else np.float64),
                rtol=r if rtol is None else rtol,
                atol=a if atol is None else atol, err_msg=where)
        else:
            np.testing.assert_array_equal(gn, wn, err_msg=where)
        return
    if isinstance(want, np.dtype) or isinstance(want, type):
        assert str(np.dtype(got) if not isinstance(got, str) else got) \
            == str(np.dtype(want)), (where, got, want)
        return
    if isinstance(want, float):
        assert abs(float(got) - want) <= 1e-6 + 1e-5 * abs(want), (
            where, got, want)
        return
    assert got == want, (where, got, want)


def parity(jax_fn, port_fn, *inputs, rtol=None, atol=None, grad=False,
           **kwargs):
    """Run `jax_fn` and `port_fn` on the same numpy `inputs` (each as its
    package's NDArray; `kwargs` passed as they are) and compare the values
    (and, with `grad`, the gradients of each output's sum with respect to
    every floating input) at per-dtype tolerances. Returns the port's
    result."""
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as tmx
    jin, tin = to_jax_args(list(inputs)), to_port_args(list(inputs))
    if not grad:
        want = jax_fn(*jin, **kwargs)
        got = port_fn(*tin, **kwargs)
        assert_parity(got, want, rtol, atol)
        return got
    diff = [i for i, v in enumerate(inputs)
            if isinstance(v, np.ndarray) and v.dtype.kind == "f"]
    for i in diff:
        jin[i].attach_grad()
        tin[i].attach_grad()
    with jmx.autograd.record():
        want = jax_fn(*jin, **kwargs)
        jhead = want if not isinstance(want, (list, tuple)) else want[0]
        jhead = jhead.sum()
    jhead.backward()
    with tmx.autograd.record():
        got = port_fn(*tin, **kwargs)
        thead = got if not isinstance(got, (list, tuple)) else got[0]
        thead = thead.sum()
    thead.backward()
    assert_parity(got, want, rtol, atol)
    for i in diff:
        assert_parity(tin[i].grad, jin[i].grad, rtol, atol, f"grad[{i}]")
    return got


# ---------------------------------------------------------------------------
# the JAX package's AMP state: a port test that calls its `amp.init` runs
# inside `jax_amp_restored()`, so that nothing it sets (the target dtype,
# which `uninit()` keeps, or the op lists `init` extends) reaches a later
# test of the same process
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def jax_amp_restored():
    """Save the JAX package's whole AMP state (`amp._state`, the op lists
    `init` mutates, the autocast suspension of this thread) and put it back
    on exit. The policy version only moves forward, so a per-op-name cache
    keyed on it never serves an entry from the state the block left."""
    from incubator_mxnet_tpu import amp as jamp
    from incubator_mxnet_tpu.amp import lists as jlists
    state = dict(jamp._state)
    lists = {n: set(getattr(jlists, n))
             for n in ("BF16_FUNCS", "FP32_FUNCS", "WIDEST_TYPE_CASTS")}
    suspended = getattr(jamp._tls, "suspended", 0)
    try:
        yield
    finally:
        version = max(jamp._state["version"], state["version"]) + 1
        jamp._state.clear()
        jamp._state.update(state, version=version)
        for n, saved in lists.items():
            live = getattr(jlists, n)
            live.clear()
            live.update(saved)
        jamp._tls.suspended = suspended


# ---------------------------------------------------------------------------
# the fault-injection state of both packages: rules, hit counts and whether
# MXNET_FAULT_SPEC was read are process-global, and the driver's workers run
# whole files one after another, so a port fault test leaves both packages'
# state as it found it
# ---------------------------------------------------------------------------
def _fault_state(mod):
    return list(mod._rules), dict(mod._hit_counts), mod._env_loaded


def _put_fault_state(mod, state):
    rules, hit_counts, env_loaded = state
    with mod._lock:
        mod._rules[:] = rules
        mod._hit_counts.clear()
        mod._hit_counts.update(hit_counts)
        mod._env_loaded = env_loaded


@contextlib.contextmanager
def jax_fault_restored():
    """Save the JAX package's fault state (`fault._rules`, `_hit_counts`,
    `_env_loaded`) and put it back on exit."""
    from incubator_mxnet_tpu import fault as jfault
    saved = _fault_state(jfault)
    try:
        yield
    finally:
        _put_fault_state(jfault, saved)


@contextlib.contextmanager
def port_faults_cleared():
    """Run a block with the port's fault registry empty (rules and hits
    cleared, MXNET_FAULT_SPEC treated as read) and put its earlier state
    back on exit, inside `jax_fault_restored()`."""
    from incubator_mxnet_tpu_torch import fault as tfault
    saved = _fault_state(tfault)
    with jax_fault_restored():
        tfault.clear()
        try:
            yield
        finally:
            _put_fault_state(tfault, saved)
