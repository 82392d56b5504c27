"""The op record's `layout`: the npx convolution, deconvolution, pooling
and fused average-pool wrappers stamp the layout they dispatched with on
their `OpInfo`, as the JAX package's do (`ops.registry.note_layout`), and
the port's `tools/torch_convert_model.py` writes the arrays that
`tools/convert_model.py` writes.

Same seeded numpy inputs into both packages on the CPU; the layout records
must be equal, the outputs within float32 rounding (rtol 1e-5).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import model_store as jstore
from incubator_mxnet_tpu_torch.ops.registry import OpInfo, note_layout

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


def _pair(a):
    return jmx.np.array(a), tmx.np.array(a, device=CPU)


def _check(name, layout, jout, tout):
    assert jmx.ops.get_op(name).layout == layout
    assert tmx.ops.get_op(name).layout == jmx.ops.get_op(name).layout
    np.testing.assert_allclose(tout.asnumpy(), np.asarray(jout.asnumpy()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW", "NHWC"])
def test_pooling_layout_record(layout):
    rng = np.random.default_rng(0)
    shape = (2, 6, 6, 3) if layout == "NHWC" else (2, 3, 6, 6)
    jx, tx = _pair(rng.standard_normal(shape).astype(np.float32))
    kw = dict(kernel=(2, 2), stride=(2, 2), pool_type="avg", layout=layout)
    _check("npx.pooling", layout, jmx.npx.pooling(jx, **kw),
           tmx.npx.pooling(tx, **kw))


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_convolution_layout_record(layout):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)   # OIHW
    if layout == "NHWC":
        jx, jw = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0)  # HWIO
    else:
        jx, jw = x, w
    jout = jmx.npx.convolution(jmx.np.array(jx), jmx.np.array(jw),
                               kernel=(3, 3), num_filter=4, no_bias=True,
                               layout=layout)
    tout = tmx.npx.convolution(tmx.np.array(jx, device=CPU),
                               tmx.np.array(w, device=CPU), kernel=(3, 3),
                               num_filter=4, no_bias=True, layout=layout)
    _check("npx.convolution", layout, jout, tout)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_deconvolution_layout_record(layout):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    w = rng.standard_normal((3, 4, 3, 3)).astype(np.float32)   # I O H W
    if layout == "NHWC":
        jx, jw = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0)
    else:
        jx, jw = x, w
    jout = jmx.npx.deconvolution(jmx.np.array(jx), jmx.np.array(jw),
                                 no_bias=True, layout=layout)
    tout = tmx.npx.deconvolution(tmx.np.array(jx, device=CPU),
                                 tmx.np.array(w, device=CPU), no_bias=True,
                                 layout=layout)
    _check("npx.deconvolution", layout, jout, tout)


def test_fused_avg_pool2d_layout_record():
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, 4, 4, 8)).astype(np.float32))
    _check("npx.fused_avg_pool2d", "NHWC",
           jmx.npx.fused_avg_pool2d(jx, 2, layout="NHWC"),
           tmx.npx.fused_avg_pool2d(tx, 2, layout="NHWC"))


def test_note_layout_contract():
    """A fresh record has no layout; `note_layout` ignores a None op or a
    None layout, and the last writer wins — as in the JAX package."""
    from incubator_mxnet_tpu.ops.registry import OpInfo as JOpInfo
    from incubator_mxnet_tpu.ops.registry import note_layout as jnote
    for cls, note in ((OpInfo, note_layout), (JOpInfo, jnote)):
        info = cls("x", lambda a: a)
        assert info.layout is None
        note(info, None)
        note(None, "NHWC")
        assert info.layout is None
        note(info, "NHWC")
        note(info, "NCHW")
        assert info.layout == "NCHW"


# ---------------------------------------------------------------------------
# tools/torch_convert_model.py against tools/convert_model.py
# ---------------------------------------------------------------------------
def _convert(tool, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", tool),
                        *args], capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("auto_map", [False, True])
def test_torch_convert_model_matches_jax_tool(tmp_path, auto_map):
    """A `.params` file written here converts to the same npz arrays
    (names, dtypes, bits) with either tool: with --rename, and with
    --auto-map alexnet over foreign names in construction order."""
    from incubator_mxnet_tpu.gluon.model_zoo import vision
    jmx.seed(9)
    net = vision.alexnet()
    net.initialize()
    net(jmx.np.zeros((1, 3, 224, 224)))
    params = [p.data().asnumpy() for _, p in net.collect_params().items()]
    foreign = {f"zoo_p{i}": np.asarray(a) for i, a in enumerate(params)}
    pfile = str(tmp_path / "zoo.params")
    jstore.save_params_file(pfile, foreign)
    args = ["--auto-map", "alexnet"] if auto_map else \
        ["--rename", "zoo_p0=features.0.weight", "--rename", "zoo_p1=b"]
    jout, tout = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jtext = _convert("convert_model.py", pfile, jout, *args)
    ttext = _convert("torch_convert_model.py", pfile, tout, *args)
    assert ("auto-map" in ttext) == auto_map == ("auto-map" in jtext)
    ja, ta = _npz(jout), _npz(tout)
    assert sorted(ta) == sorted(ja)
    assert len(ta) == len(foreign)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k])
    if not auto_map:
        assert {"features.0.weight", "b", "zoo_p2"} <= set(ta)
