"""PyTorch port: `HybridBlock.export`, `deploy.ExportedModel`,
`gluon.SymbolBlock` and `serve.BucketedModel` against the JAX package.

A small NHWC ResNet v1 (`torch_port_utils.resnet_pair`: the same values in
both packages, made with numpy from a seed and carried across with
`gluon.params_from_jax`) is exported by both packages and run from the
artifacts. Tolerances: float32 on both sides, only the summation orders
differ (XLA's CPU convolutions against PyTorch's): 1e-4 relative and
absolute. Under bf16 AMP both round at the same op boundaries but
accumulate differently: 2e-2 relative plus 2e-2 of the largest logit.

The port's export traces the fused tier: its apply and pool forwards are
the custom ops `mxtorch.scale_shift_act` / `mxtorch.avg_pool2d_fwd`, which
take their plain versions on the CPU. `torch.library.opcheck` holds every
arity and activation of them.
"""
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import deploy as jdeploy

from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import amp as tamp
from incubator_mxnet_tpu_torch import deploy as tdeploy
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.ops import fused as tfused, kernels

from torch_port_utils import resnet_pair, resnet_batch, jax_amp_restored

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
BF16_RTOL = 2e-2


def _export_pair(tmp_path, thumbnail=False, seed=0, batch=4):
    jnet, tnet = resnet_pair(thumbnail, seed=seed)
    x, _ = resnet_batch(thumbnail, batch=batch)
    jnet.export(str(tmp_path / "jax"), example_inputs=mx.np.array(x))
    with tfused.fusion_scope(True):
        paths = tnet.export(str(tmp_path / "port"),
                            example_inputs=torch.from_numpy(x))
    return jnet, tnet, x, paths


def test_export_writes_the_artifact_set(tmp_path):
    _, tnet, x, paths = _export_pair(tmp_path)
    prefix = str(tmp_path / "port-0000")
    assert paths == (f"{prefix}.params.npz", f"{prefix}.pt2",
                     f"{prefix}.deploy.json")
    # without example inputs only the weights are written
    assert tnet.export(str(tmp_path / "w"), epoch=3) == \
        (str(tmp_path / "w-0003.params.npz"),)


def test_manifests_equal_but_the_program_file(tmp_path):
    _export_pair(tmp_path)
    with open(tmp_path / "jax-0000.deploy.json") as f:
        want = json.load(f)
    with open(tmp_path / "port-0000.deploy.json") as f:
        got = json.load(f)
    assert got.pop("program") == "port-0000.pt2"
    assert got == want


def test_exported_model_run_matches_jax_float32(tmp_path):
    jnet, tnet, x, _ = _export_pair(tmp_path)
    want = jdeploy.ExportedModel(str(tmp_path / "jax-0000")).run(x)
    model = tdeploy.ExportedModel(str(tmp_path / "port-0000"), device="cpu")
    got = model.run(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # and bit-equal to the port's own eager forward of the fused tier
    with tfused.fusion_scope(True):
        eager = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, eager)
    assert (model.num_inputs, model.output_arity, model.batch_size) == \
        (1, 1, len(x))
    assert model.compile_cache_size() == 1
    assert isinstance(model.lowered(), torch.export.ExportedProgram)


@jax_amp_restored()
def test_exported_model_run_matches_jax_under_bf16_amp(tmp_path):
    jnet, tnet = resnet_pair(False, seed=3)
    x, _ = resnet_batch(False, seed=4)
    jamp.init("bfloat16")
    try:
        jnet.export(str(tmp_path / "jax"), example_inputs=mx.np.array(x))
    finally:
        jamp.uninit()
    want = np.asarray(jdeploy.ExportedModel(str(tmp_path / "jax-0000"))
                      .run(x)).astype(np.float32)
    tamp.init("bfloat16")
    try:
        with tfused.fusion_scope(True):
            tnet.export(str(tmp_path / "port"),
                        example_inputs=torch.from_numpy(x))
    finally:
        tamp.uninit()
    model = tdeploy.ExportedModel(str(tmp_path / "port-0000"), device="cpu")
    got = model.run(x)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max())


def _count_plain(monkeypatch):
    calls = {"apply": 0, "pool": 0}
    apply_ref, pool_ref = tfused.apply_ref, tfused.avg_pool2d_ref

    def apply(*a, **k):
        calls["apply"] += 1
        return apply_ref(*a, **k)

    def pool(*a, **k):
        calls["pool"] += 1
        return pool_ref(*a, **k)
    monkeypatch.setattr(tfused, "apply_ref", apply)
    monkeypatch.setattr(tfused, "avg_pool2d_ref", pool)
    return calls


def test_export_runs_no_kernel_and_the_program_runs_each_node(
        tmp_path, monkeypatch):
    """Export traces with fake tensors: no implementation of the custom
    ops runs, so no launch counter can move; each run of the program runs
    each node once."""
    jnet, tnet = resnet_pair(False, seed=1)
    x, _ = resnet_batch(False)
    calls = _count_plain(monkeypatch)
    kernels.reset_launch_counts()
    with tfused.fusion_scope(True):
        tnet.export(str(tmp_path / "port"),
                    example_inputs=torch.from_numpy(x))
    assert calls == {"apply": 0, "pool": 0}
    assert all(v == 0 for v in kernels.launch_counts().values())
    model = tdeploy.ExportedModel(str(tmp_path / "port-0000"), device="cpu")
    graph = model.lowered().graph
    n_apply = sum("mxtorch.scale_shift_act" in str(n.target)
                  for n in graph.nodes)
    n_pool = sum("mxtorch.avg_pool2d_fwd" in str(n.target)
                 for n in graph.nodes)
    # ResNetV1(BottleneckV1, [1, 1]): the stem's BN, 3 BN a bottleneck and
    # each downsample's BN (both stages), one global pool
    assert (n_apply, n_pool) == (9, 1)
    model.run(x)
    assert calls == {"apply": n_apply, "pool": n_pool}


def test_symbolblock_imports_and_param_file_swap(tmp_path):
    _, tnet_a, x, _ = _export_pair(tmp_path, seed=0)
    _, tnet_b = resnet_pair(False, seed=5)
    tnet_b.save_parameters(str(tmp_path / "b.params.npz"))
    xt = torch.from_numpy(x)
    with tfused.fusion_scope(True):
        want_a, want_b = tnet_a(xt), tnet_b(xt)
    blk = tgluon.SymbolBlock.imports(str(tmp_path / "port-0000.pt2"),
                                     device="cpu")
    np.testing.assert_array_equal(blk(xt).numpy(), want_a.numpy())
    # the same program over another net's weights, no new export
    blk_b = tgluon.SymbolBlock.imports(
        str(tmp_path / "port-0000"),
        param_file=str(tmp_path / "b.params.npz"), device="cpu")
    got = blk_b(xt)
    np.testing.assert_array_equal(got.numpy(), want_b.numpy())
    assert not np.allclose(want_a.numpy(), want_b.numpy())
    # and the JAX package's own weights file loads too
    jnet, _ = resnet_pair(False, seed=5)
    jnet.save_parameters(str(tmp_path / "j.params.npz"))
    blk_j = tgluon.SymbolBlock.imports(
        str(tmp_path / "port-0000"),
        param_file=str(tmp_path / "j.params.npz"), device="cpu")
    np.testing.assert_allclose(blk_j(xt).numpy(), want_b.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_legacy_symbol_json_raises_naming_a12(tmp_path):
    with pytest.raises(MXNetError, match="A12"):
        tgluon.SymbolBlock.imports(str(tmp_path / "net-symbol.json"))


def test_no_card_no_cpu_fallback(tmp_path):
    """The entry points default to the card: without one they raise,
    they never run on the CPU unasked."""
    _export_pair(tmp_path)
    with pytest.raises(MXNetError):
        tdeploy.ExportedModel(str(tmp_path / "port-0000"))
    with pytest.raises(MXNetError):
        tserve.CallableModel(lambda x: x, (1,), [((3,), "float32")])
    with pytest.raises(MXNetError, match="missing"):
        tdeploy.ExportedModel(str(tmp_path / "absent-0000"), device="cpu")
    assert tdeploy.maybe_enable_compile_cache() is False


def test_bucketed_model_serves_exported_buckets(tmp_path):
    _, tnet = resnet_pair(True, seed=2)
    x, _ = resnet_batch(True, batch=7)
    with tfused.fusion_scope(True):
        model = tserve.BucketedModel.export_block(
            tnet, (8, 8, 3), (1, 2, 4), str(tmp_path), name="r",
            device="cpu")
        want = tnet(torch.from_numpy(x)).numpy()
    assert model.batch_sizes == [1, 2, 4]
    assert model.row_specs == [((8, 8, 3), "float32")]
    again = tserve.BucketedModel.from_prefixes(
        [str(tmp_path / f"r-b{b}-0000") for b in (1, 2, 4)], device="cpu")
    assert again.batch_sizes == [1, 2, 4]
    with tserve.Server(model, batch_timeout_ms=20.0) as srv:
        outs = [f.result(timeout=60) for f in [srv.submit(r) for r in x]]
        st = srv.stats()
    np.testing.assert_allclose(np.stack(outs), want, rtol=1e-5, atol=1e-5)
    assert st["replies"] == 7 and st["compile_cache_size"] == 3


ACTS = tfused.FUSABLE_ACTS


@pytest.mark.parametrize("arity", ["bias", "scale_shift", "residual"])
@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
def test_opcheck_scale_shift_act(arity, act):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    scale = torch.from_numpy(rng.rand(8).astype(np.float32))
    shift = torch.from_numpy(rng.randn(8).astype(np.float32))
    res = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    args = {"bias": (x, None, shift, None, act),
            "scale_shift": (x, scale, shift, None, act),
            "residual": (x, scale, shift, res, act)}[arity]
    torch.library.opcheck(tfused.scale_shift_act_op, args)
    out = tfused.scale_shift_act_op(*args)
    torch.testing.assert_close(out, tfused.apply_ref(*args, -1), rtol=0,
                               atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_opcheck_avg_pool2d_fwd(dtype):
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 4, 6, 5)
                         .astype(np.float32)).to(dtype)
    torch.library.opcheck(tfused.avg_pool2d_fwd_op, (x, 2, 3))
    torch.testing.assert_close(tfused.avg_pool2d_fwd_op(x, 2, 3),
                               tfused.avg_pool2d_ref(x, (2, 3)), rtol=0,
                               atol=0)


def test_artifacts_hold_no_weights_and_no_device(tmp_path):
    """The program file holds no parameter values (the weights come from
    the `.params.npz` alone); the device it was traced on appears only in
    the metadata asserts of its inputs, which ExportedModel rewrites to
    the device asked for."""
    _, _, _, paths = _export_pair(tmp_path)
    program = torch.export.load(paths[1])
    assert not program.state_dict and not program.constants
    assert program.example_inputs is None
    named = {str(n.target) for n in program.graph.nodes
             if "device" in n.kwargs}
    assert named <= {"aten._assert_tensor_metadata.default"}, named
