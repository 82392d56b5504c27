"""PyTorch port: the public names ROADMAP A5 lists as missing, against the
JAX package's values and behaviour on the CPU.

  * `amp`: `autocast(active)` nested as the JAX package nests it (the
    same `is_active()` readings at each step, on this thread), the
    policy it turns on casting the port's ops, `lists_version`, `init`'s
    op-list arguments, `lists.WIDEST_TYPE_CASTS`, `convert_hybrid_block`;
  * `base`: the seven error classes (each an MXNetError and the builtin
    it names), `DTYPE_NAMES`, `dtype_to_name`, `integer_types`,
    `string_types`; `num_tpus` at the root;
  * `engine`: `set_naive`, `is_naive`, `effective_bulk_size` under the
    same env settings;
  * `ops`: `invoke`, `register_op`, `get_op`, `list_ops`, `apply_op` at
    package level, and the Faster-RCNN records' AMP classes;
  * `gluon.model_zoo.get_model`;
  * `runtime`, `util`, `test_utils` and `visualization`: the JAX
    package's names, the same values where they are not facts of the
    build, and `plot_network`'s dot text equal for the same zoo net.
Every test runs inside `process_state_kept()`, with both packages' AMP
state put back.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import base as jbase
from incubator_mxnet_tpu import engine as jengine
from incubator_mxnet_tpu.amp import lists as jlists
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch import base as tbase
from incubator_mxnet_tpu_torch import engine as tengine
from incubator_mxnet_tpu_torch.amp import lists as tlists

from torch_port_utils import (jax_amp_restored, port_amp_restored,
                              process_state_kept)

torch.set_num_threads(1)

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _kept():
    with process_state_kept(), jax_amp_restored(), port_amp_restored():
        prev = tengine._naive[0], jengine._naive[0]
        try:
            yield
        finally:
            tengine._naive[0], jengine._naive[0] = prev


# ---------------------------------------------------------------------------
# amp
# ---------------------------------------------------------------------------
def _autocast_trace(amp):
    """is_active() at each step of a nested run of autocast scopes, from
    an inactive policy."""
    out = [amp.is_active()]
    with amp.autocast(True):
        out.append(amp.is_active())
        with amp.autocast(False):
            out.append(amp.is_active())
            with amp.autocast(True):
                out.append(amp.is_active())
            out.append(amp.is_active())
            with amp.autocast(False):
                out.append(amp.is_active())
            out.append(amp.is_active())
        out.append(amp.is_active())
    out.append(amp.is_active())
    amp.init("bfloat16")
    with amp.autocast(False):
        out.append(amp.is_active())
    out.append(amp.is_active())
    amp.uninit()
    out.append(amp.is_active())
    return out


def test_autocast_nests_as_jax():
    want = _autocast_trace(jamp)
    assert _autocast_trace(tamp) == want
    assert want == [False, True, False, True, False, False, False, True,
                    False, False, True, False]


def test_autocast_turns_the_policy_on_for_the_ports_ops():
    x = tmx.np.ones((2, 3), device=CPU)
    w = tmx.np.ones((4, 3), device=CPU)
    with tamp.autocast(True):
        y = tmx.npx.fully_connected(x, w, num_hidden=4, no_bias=True)
        with tamp.autocast(False):
            z = tmx.npx.fully_connected(x, w, num_hidden=4, no_bias=True)
    assert str(y.dtype) == "bfloat16" and str(z.dtype) == "float32"
    assert str(tmx.npx.fully_connected(x, w, num_hidden=4,
                                       no_bias=True).dtype) == "float32"


def test_lists_version_and_init_op_lists_as_jax():
    for amp, lists in ((jamp, jlists), (tamp, tlists)):
        v0 = amp.lists_version()
        amp.init("float16", target_precision_ops=["my_low_op"],
                 conditional_fp32_ops=[("x", "y", ["z"])],
                 fp32_ops=["my_f32_op"])
        assert amp.lists_version() == v0 + 1
        assert amp.target_dtype() == "float16"
        assert amp.amp_dtype_for("npx.my_low_op") == "float16"
        assert amp.amp_dtype_for("my_f32_op") == "float32"
        amp.uninit()
        assert amp.lists_version() == v0 + 2
        assert amp.amp_dtype_for("my_low_op") is None
    assert tlists.WIDEST_TYPE_CASTS == jlists.WIDEST_TYPE_CASTS == set()
    assert set(jamp.__all__) - {"unscale"} <= set(tamp.__all__)


def test_convert_hybrid_block_casts_as_jax():
    def dtypes(net):
        return {n: str(p.data().dtype).replace("torch.", "")
                for n, p in net.collect_params().items()}

    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(4, in_units=3), jmx.gluon.nn.BatchNorm(
        in_channels=4))
    jnet.initialize()
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(4, in_units=3), tmx.gluon.nn.BatchNorm(
        in_channels=4))
    tnet.initialize(device="cpu")
    assert jamp.convert_hybrid_block(jnet) is jnet
    assert tamp.convert_hybrid_block(tnet) is tnet
    assert dtypes(tnet) == dtypes(jnet)
    assert set(dtypes(tnet).values()) == {"bfloat16"}
    tamp.convert_hybrid_block(tnet, target_dtype="float16",
                              cast_params=False)
    assert set(dtypes(tnet).values()) == {"bfloat16"}


# ---------------------------------------------------------------------------
# base and the root
# ---------------------------------------------------------------------------
ERRORS = ["InternalError", "NotImplementedForSymbol", "ValueError_",
          "TypeError_", "IndexError_", "AttributeError_",
          "NotImplementedError_"]


@pytest.mark.parametrize("name", ERRORS)
def test_error_classes_as_jax(name):
    jcls, tcls = getattr(jbase, name), getattr(tbase, name)
    assert issubclass(tcls, tbase.MXNetError)
    for builtin in (ValueError, TypeError, IndexError, AttributeError,
                    NotImplementedError, RuntimeError):
        assert issubclass(tcls, builtin) == issubclass(jcls, builtin)
    with pytest.raises(tmx.MXNetError):
        raise tcls("x")


def test_dtype_names_and_type_tuples_as_jax():
    assert tbase.DTYPE_NAMES == jbase.DTYPE_NAMES
    for name in jbase.DTYPE_NAMES:
        jd = jbase.name_to_dtype(name)
        assert tbase.dtype_to_name(jd) == jbase.dtype_to_name(jd) == name
        assert tbase.dtype_to_name(tbase.name_to_dtype(name)) == name
    assert tbase.dtype_to_name(tbase.BFLOAT16) == "bfloat16"
    assert tbase.dtype_to_name("float16") == "float16"
    for v in (3, np.int16(2), np.int64(5), True, 2.0, "s", np.float32(1)):
        assert isinstance(v, tbase.integer_types) == \
            isinstance(v, jbase.integer_types)
        assert isinstance(v, tbase.string_types) == \
            isinstance(v, jbase.string_types)
    assert set(jbase.__all__) <= set(tbase.__all__)


def test_num_tpus_at_the_root():
    assert tmx.num_tpus() == tmx.num_gpus() == torch.cuda.device_count()
    assert "num_tpus" in tmx.__all__


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _engine_trace(engine, monkeypatch):
    out = []
    monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    out.append((engine.is_naive(), engine.effective_bulk_size()))
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    out.append((engine.is_naive(), engine.effective_bulk_size()))
    out.append(engine.set_naive(False))
    out.append((engine.is_naive(), engine.effective_bulk_size()))
    out.append(engine.set_naive(True))
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    out.append((engine.is_naive(), engine.effective_bulk_size()))
    out.append(engine.set_naive(None))
    out.append((engine.is_naive(), engine.effective_bulk_size()))
    return out


def _engine_traces(monkeypatch):
    """Both packages' traces, each from no override: a JAX test that
    restores with `set_naive(prev)` leaves the effective bool behind, so
    both overrides are set to None first (the fixture puts them back)."""
    monkeypatch.delenv("MXNET_ENGINE_BULK_SIZE", raising=False)
    tengine._naive[0] = jengine._naive[0] = None
    return (_engine_trace(jengine, monkeypatch),
            _engine_trace(tengine, monkeypatch))


def test_naive_engine_as_jax(monkeypatch):
    want, got = _engine_traces(monkeypatch)
    assert got == want
    assert want[0] == (False, 4096) and want[1] == (True, 0)
    assert set(jengine.__all__) <= set(tengine.__all__)


@pytest.mark.parametrize("jax_left, port_left", [(False, None),
                                                 (False, True)])
def test_naive_engine_after_a_stuck_override(monkeypatch, jax_left,
                                             port_left):
    """The trace as another test file leaves the engines: the JAX
    package's override stuck at False (`tests/test_dispatch.py` restores
    with `set_naive(prev)`), the port's at None or stuck too."""
    jengine.set_naive(jax_left)
    tengine._naive[0] = port_left
    want, got = _engine_traces(monkeypatch)
    assert got == want
    assert want[0] == (False, 4096) and want[1] == (True, 0)


@pytest.mark.parametrize("value", ["cpu(0)", "cpu", None])
def test_default_device_knob_as_jax(monkeypatch, value):
    """`MXNET_DEFAULT_DEVICE` names the default device in both packages:
    "cpu(0)" and "cpu" are the CPU for `current_device()` and a new
    array; unset, the port keeps the card (it raises without one) where
    the JAX package takes its accelerator or the CPU. The knob is
    registered with the JAX package's type, default and help."""
    import incubator_mxnet_tpu.device  # noqa: F401 - registers the knob
    if value is None:
        monkeypatch.delenv("MXNET_DEFAULT_DEVICE", raising=False)
    else:
        monkeypatch.setenv("MXNET_DEFAULT_DEVICE", value)
    assert tmx.env_flags()["MXNET_DEFAULT_DEVICE"] == \
        jmx.env_flags()["MXNET_DEFAULT_DEVICE"]
    if value is None:
        assert tmx.current_device() == tmx.gpu(0)
        if not torch.cuda.is_available():
            with pytest.raises(tmx.MXNetError, match="cuda"):
                tmx.np.zeros((2,))
        return
    assert repr(tmx.current_device()) == repr(jmx.current_device()) \
        == "cpu(0)"
    got, want = tmx.np.array([1.0, 2.0]), jmx.np.array([1.0, 2.0])
    assert repr(got.device) == repr(want.device) == "cpu(0)"
    assert got._t.device.type == "cpu"
    with tmx.gpu(0):
        assert tmx.current_device() == tmx.gpu(0)


def test_naive_dispatch_runs_ops(monkeypatch):
    """Under NaiveEngine an op on CPU arrays runs as before (the wait for
    the card applies to CUDA arrays only)."""
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    x = tmx.np.array([1.0, 2.0], device=CPU)
    np.testing.assert_array_equal((x * 2 + 1).asnumpy(), [3.0, 5.0])


# ---------------------------------------------------------------------------
# ops, the zoo's get_model
# ---------------------------------------------------------------------------
def test_ops_registry_names_at_package_level():
    from incubator_mxnet_tpu_torch.ops import registry
    for name in jmx.ops.__all__:
        assert getattr(tmx.ops, name) is getattr(registry, name), name
    names = tmx.ops.list_ops()
    for n in ("roi_align", "bilinear_resize2d", "proposal",
              "deformable_convolution", "psroi_pooling"):
        assert f"npx.{n}" in names
        assert tmx.ops.get_op(f"npx.{n}").amp == \
            jmx.ops.get_op(f"npx.{n}").amp
    out = tmx.ops.apply_op("npx.bilinear_resize2d",
                           torch.ones((1, 1, 2, 2)), height=3, width=3)
    assert out.shape == (1, 1, 3, 3) and torch.allclose(out, torch.ones(1))


def test_model_zoo_get_model_at_package_level():
    assert tmx.gluon.model_zoo.get_model is \
        tmx.gluon.model_zoo.vision.get_model
    net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=10,
                                        device="cpu")
    jnet = jmx.gluon.model_zoo.get_model("resnet18_v1", classes=10)
    assert list(net.collect_params()) == list(jnet.collect_params())


# ---------------------------------------------------------------------------
# runtime, util, test_utils, visualization
# ---------------------------------------------------------------------------
def test_runtime_features_have_the_jax_keys_and_the_ports_facts():
    jf, tf = jmx.runtime.Features(), tmx.runtime.Features()
    assert list(tf) == list(jf)
    assert tf.is_enabled("cuda") == torch.cuda.is_available()
    for off in ("XLA", "PALLAS", "TPU", "SPMD", "DIST_KVSTORE"):
        assert not tf.is_enabled(off)
    assert tf.is_enabled("cpu") and tf.is_enabled("BF16")
    assert [f.name for f in tmx.runtime.feature_list()] == list(jf)
    assert repr(tf["CPU"]) == repr(jf["CPU"])


def test_util_as_jax():
    ju, tu = jmx.util, tmx.util
    assert set(ju.__all__) <= set(tu.__all__)
    for name in ("is_np_shape", "is_np_array"):
        assert getattr(tu, name)() == getattr(ju, name)()
    f = lambda x: x                                          # noqa: E731
    assert tu.use_np(f) is f and tu.use_np_shape(f) is f
    with tu.np_shape(True), tu.np_array(False):
        pass
    # no card here: the JAX package's 0 too
    assert tu.get_max_supported_compute_capability() == 0
    a = tu.default_array([1, 2], ctx=CPU)
    assert a.asnumpy().tolist() == [1, 2]


def test_util_env_helpers(monkeypatch):
    monkeypatch.setenv("MXNET_TEST_SEED", "7")
    assert tmx.util.getenv("MXNET_TEST_SEED") == \
        jmx.util.getenv("MXNET_TEST_SEED") == 7
    tmx.util.setenv("MXNET_TEST_SEED", 8)
    assert jmx.util.getenv("MXNET_TEST_SEED") == 8


def test_test_utils_as_jax():
    jt, tt = jmx.test_utils, tmx.test_utils
    assert tt.__all__ == jt.__all__
    for dt in ("float16", "bfloat16", "float32", "float64", "int8"):
        assert tt.default_rtols(dt) == jt.default_rtols(dt)
        assert tt.default_atols(dt) == jt.default_atols(dt)
    a = np.array([1.0, 2.0], np.float32)
    b = a + np.float32(5e-5)
    assert tt.almost_equal(a, b) == jt.almost_equal(a, b)
    assert tt.same(a, a.copy()) and not tt.same(a, b)
    with tmx.cpu():
        tt.assert_almost_equal(tmx.np.array(a), b)
        with pytest.raises(AssertionError):
            tt.assert_almost_equal(tmx.np.array(a), a + 1)
        x = np.random.RandomState(0).randn(3, 2)
        tt.check_numeric_gradient(lambda v: (v * v).sum(), [x])
        got = tt.check_consistency(lambda v: v * 2, [CPU], [x])
        np.testing.assert_allclose(got[0], 2 * x, rtol=1e-6)
        r = tt.rand_ndarray((2, 3))
        assert r.shape == (2, 3) and str(r.dtype) == "float32"
    with pytest.raises(tmx.MXNetError, match="A12"):
        tt.rand_ndarray((2, 3), stype="csr")
    assert tt.default_context() == tmx.current_device()


def test_plot_network_text_equals_the_jax_packages(tmp_path):
    jnet = jmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    tnet = tmx.gluon.model_zoo.vision.resnet18_v1(classes=10, device="cpu")
    want = jmx.visualization.plot_network(jnet, title="r18")
    path = tmp_path / "r18.dot"
    got = tmx.visualization.plot_network(tnet, title="r18",
                                         save_path=str(path))
    assert got == want and path.read_text() == want
    rows = tmx.visualization.print_summary(tnet, torch.zeros((1, 3, 32, 32)))
    assert "Dense" in str(rows)
