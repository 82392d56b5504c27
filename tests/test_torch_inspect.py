"""PyTorch port: `inspect.roofline` and `inspect.report` held against the
JAX package's, on the CPU.

Covered: `classify` and `load_calibration` (explicit path, the env
override, the platform guard) against the JAX package's; the card's spec
row (its data-sheet peaks, no TPU figure); a product's and a convolution's
unit flops equal to the JAX package's `instr_flops` for the same shapes,
exactly (2·M·N·K), and a product's bytes equal to its `unit_cost`'s; the
report's keys against the JAX report's for the same small training step
(less `cost_analysis` and `model_vs_xla_flops`); the `inspect.*` metrics
moving as the JAX package's do; `render_markdown`'s headers, an atomic
`dump_json`, MXNET_INSPECT_TOP_K; `class_name` folding template instances
of CUDA symbols; `kernel_cost` reproducing PERF.md section 6's bound column
at the rows' shapes to the table's 4 decimals; the attribution of device
records to launch spans over a chrome trace made here; a unit's floor
(every byte through the L2 at its rate, device memory spared at most
twice the L2's size) against its cold bound; the launch sites folded over
calls that differ; and a `tools/torch_offenders.py --device cpu` smoke.

No test needs a card: on the CPU a report is the cost model's, `measured:
false` with the reason "no CUDA device".
"""
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import inspect as jinspect
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.gluon.contrib import \
    FusedTrainStep as JFusedTrainStep
from incubator_mxnet_tpu.inspect import hlo as jhlo
from incubator_mxnet_tpu.inspect import report as jreport
from incubator_mxnet_tpu.inspect import roofline as jroofline
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import inspect as tinspect
from incubator_mxnet_tpu_torch import optimizer as topt
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.gluon.contrib import estimator as test
from incubator_mxnet_tpu_torch.gluon.contrib import \
    FusedTrainStep as TFusedTrainStep
from incubator_mxnet_tpu_torch.inspect import report as treport
from incubator_mxnet_tpu_torch.inspect import roofline as troofline
from incubator_mxnet_tpu_torch.ops import kernels

from torch_port_utils import expire_port_trace_memo, process_state_kept

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("MXNET_INSPECT_TOP_K", "MXNET_INSPECT_MEASURED",
         "MXNET_INSPECT_CALIB")


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    calib_paths = (jroofline.CALIB_PATH, troofline.CALIB_PATH)
    expire_port_trace_memo()
    try:
        with process_state_kept():
            try:
                yield
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
                jroofline.CALIB_PATH, troofline.CALIB_PATH = calib_paths
                assert kernels._CAPTURE is None
    finally:
        expire_port_trace_memo()


# ---------------------------------------------------------------------------
# classification and calibration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("intensity,ridge", [(10.0, 5.0), (2.0, 5.0),
                                             (5.0, 5.0), (0.0, 295.2)])
def test_classify_as_jax(intensity, ridge):
    assert troofline.classify(intensity, ridge) == \
        jroofline.classify(intensity, ridge)


def test_load_calibration_explicit_path_and_ridge(tmp_path):
    p = tmp_path / "calib.json"
    p.write_text(json.dumps({"peak_flops": 1e12, "peak_bytes_per_sec": 1e11,
                             "platform": "tpu"}))
    got = troofline.load_calibration(path=str(p))
    want = jroofline.load_calibration(path=str(p))
    for k in ("peak_flops", "peak_bytes_per_sec", "ridge_flop_per_byte",
              "source"):
        assert got[k] == want[k], k
    assert got["ridge_flop_per_byte"] == 10.0


def test_load_calibration_env_override(tmp_path):
    p = tmp_path / "calib.json"
    p.write_text(json.dumps({"peak_flops": 2e12,
                             "peak_bytes_per_sec": 1e11}))
    os.environ["MXNET_INSPECT_CALIB"] = str(p)
    assert troofline.load_calibration()["peak_flops"] == \
        jroofline.load_calibration()["peak_flops"] == 2e12


def test_load_calibration_platform_guard(tmp_path):
    p = tmp_path / "roofline_calib.json"
    p.write_text(json.dumps({"peak_flops": 9e13, "peak_bytes_per_sec": 1e12,
                             "platform": "not_this_platform"}))
    jroofline.CALIB_PATH = troofline.CALIB_PATH = str(p)
    for mod in (jroofline, troofline):
        cal = mod.load_calibration(platform="cpu")
        assert cal["source"] == "spec-fallback"
        assert cal["peak_flops"] == mod.DEFAULT_CALIBRATIONS["cpu"][
            "peak_flops"]
    p.write_text("{not json")
    assert troofline.load_calibration(platform="cpu")["source"] == \
        jroofline.load_calibration(platform="cpu")["source"] == \
        "spec-fallback"
    # the same file, named explicitly, is trusted across platforms
    p.write_text(json.dumps({"peak_flops": 9e13, "peak_bytes_per_sec": 1e12,
                             "platform": "not_this_platform"}))
    assert troofline.load_calibration(path=str(p),
                                      platform="cpu")["peak_flops"] == 9e13


def test_the_cards_spec_row():
    gpu = troofline.load_calibration(platform="gpu")
    assert gpu["peak_flops"] == 989e12
    assert gpu["peak_flops_by_type"] == {"bfloat16": 989e12,
                                         "float16": 989e12, "tf32": 495e12,
                                         "float32": 67e12}
    assert gpu["peak_bytes_per_sec"] == 3.35e12
    assert gpu["ridge_flop_per_byte"] == pytest.approx(989e12 / 3.35e12)
    assert "H100" in gpu["name"]
    assert "tpu" not in troofline.DEFAULT_CALIBRATIONS
    assert troofline.peak_for(gpu, "float32") == 67e12
    assert troofline.peak_for(gpu, None) == 989e12


# ---------------------------------------------------------------------------
# unit costs against the JAX package's HLO model
# ---------------------------------------------------------------------------
def _hlo_instr(text, name):
    module = jhlo.parse_module(text)
    for comp in module.computations.values():
        for ins in comp.instructions:
            if ins.name == name:
                return ins, module
    raise KeyError(name)


def _units_of(fn, *args):
    rep = treport.inspect_step(fn, *args, steps=1)
    return rep["units"], rep


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (7, 33, 5), (1, 512, 3)])
def test_product_flops_and_bytes_equal_jax(m, k, n):
    text = f"""HloModule dot_module
ENTRY %main (a: f32[{m},{k}], b: f32[{k},{n}]) -> f32[{m},{n}] {{
  %a = f32[{m},{k}]{{1,0}} parameter(0)
  %b = f32[{k},{n}]{{1,0}} parameter(1)
  ROOT %dot.1 = f32[{m},{n}]{{1,0}} dot(f32[{m},{k}]{{1,0}} %a, f32[{k},{n}]{{1,0}} %b), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
}}
"""
    ins, module = _hlo_instr(text, "dot.1")
    jflops = jroofline.instr_flops(ins, module)
    jcost = jroofline.unit_cost(ins, module)
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    units, _ = _units_of(lambda x, y: x @ y, a, b)
    (mm,) = [u for u in units if u["opcode"] == "aten::mm"]
    assert mm["flops"] == jflops == 2 * m * n * k
    assert mm["bytes"] == jcost["bytes"]
    assert (mm["in_bytes"], mm["out_bytes"]) == (jcost["in_bytes"],
                                                 jcost["out_bytes"])


@pytest.mark.parametrize("shape,cout,ksize", [((2, 8, 8, 3), 16, 3),
                                              ((1, 9, 7, 4), 6, 1)])
def test_convolution_flops_equal_jax(shape, cout, ksize):
    n, h, w, c = shape
    pad = ksize // 2
    text = f"""HloModule conv_module
ENTRY %main (x: f32[{n},{h},{w},{c}], k: f32[{ksize},{ksize},{c},{cout}]) -> f32[{n},{h},{w},{cout}] {{
  %x = f32[{n},{h},{w},{c}]{{3,2,1,0}} parameter(0)
  %k = f32[{ksize},{ksize},{c},{cout}]{{3,2,1,0}} parameter(1)
  ROOT %convolution.1 = f32[{n},{h},{w},{cout}]{{3,2,1,0}} convolution(f32[{n},{h},{w},{c}]{{3,2,1,0}} %x, f32[{ksize},{ksize},{c},{cout}]{{3,2,1,0}} %k), window={{size={ksize}x{ksize} pad={pad}_{pad}x{pad}_{pad}}}, dim_labels=b01f_01io->b01f
}}
"""
    ins, module = _hlo_instr(text, "convolution.1")
    jflops = jroofline.instr_flops(ins, module)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32))
    k = torch.from_numpy(rng.randn(cout, c, ksize, ksize).astype(np.float32))
    units, _ = _units_of(
        lambda a, b: torch.nn.functional.conv2d(a, b, padding=pad), x, k)
    conv = [u for u in units if "convolution" in u["opcode"]]
    assert len(conv) == 1
    assert conv[0]["flops"] == jflops == \
        2 * n * h * w * cout * c * ksize * ksize


def test_inplace_and_factory_bytes():
    x = torch.ones(256, 64)
    units, _ = _units_of(lambda t: (torch.zeros_like(t), t.clone().fill_(2),
                                    t.clone().add_(1)), x)
    by_op = {u["opcode"]: u for u in units}
    nb = 256 * 64 * 4
    assert by_op["aten::zeros_like"]["bytes"] == nb        # written only
    assert by_op["aten::fill_.Scalar"]["bytes"] == nb      # not read
    assert by_op["aten::add_.Tensor"]["bytes"] == 2 * nb   # read, written


def test_callable_cost_counts_with_flop_counter():
    a, b = torch.ones(32, 16), torch.ones(16, 8)
    got = troofline.callable_cost(lambda x, y: x @ y, a, b)
    assert got["est_flops"] == 2 * 32 * 16 * 8
    assert got["est_bytes"] == 4 * (32 * 16 + 16 * 8 + 32 * 8)
    assert got["flops_source"] == "flop-counter"
    assert got["bound"] == troofline.classify(
        got["est_flops"] / got["est_bytes"],
        troofline.load_calibration()["ridge_flop_per_byte"])


# ---------------------------------------------------------------------------
# the report against the JAX package's
# ---------------------------------------------------------------------------
def _tiny_steps():
    """The same tiny Dense step in both packages (the JAX net's values
    carried into the port)."""
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, activation="relu", in_units=8),
             jgluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    jnet.hybridize()
    tnet = tgluon.nn.HybridSequential()
    tnet.add(tgluon.nn.Dense(16, activation="relu", in_units=8),
             tgluon.nn.Dense(4, in_units=16))
    tnet.initialize(device="cpu")
    tgluon.params_from_jax(tnet, {n: np.asarray(p.data().asnumpy())
                                  for n, p in jnet.collect_params().items()})
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    y = np.random.RandomState(1).randn(4, 4).astype(np.float32)
    jl, tl = jgluon.loss.L2Loss(), tgluon.loss.L2Loss()
    jstep = JFusedTrainStep(jnet, lambda n, a, b: jl(n(a), b).mean(),
                            jopt.create("sgd", learning_rate=0.1))
    tstep = TFusedTrainStep(tnet, lambda n, a, b: tl(n(a), b).mean(),
                            topt.create("sgd", learning_rate=0.1))
    return (jstep, jmx.np.array(x), jmx.np.array(y)), \
        (tstep, torch.from_numpy(x), torch.from_numpy(y))


def test_report_keys_match_jax():
    (js, jx, jy), (ts, tx, ty) = _tiny_steps()
    jrep = jinspect.inspect_step(js, jx, jy, name="tiny")
    trep = tinspect.inspect_step(ts, tx, ty, name="tiny")
    missing = set(jrep) - set(trep)
    assert missing == {"cost_analysis", "model_vs_xla_flops"}
    assert set(jrep["calibration"]) <= set(trep["calibration"])
    assert set(jrep["totals"]) <= set(trep["totals"])
    assert set(jrep["offenders"][0]) <= set(trep["offenders"][0])
    assert set(jrep["offender_groups"][0]) <= set(
        trep["offender_groups"][0])
    assert trep["measured"] is False
    assert trep["measured_unavailable_reason"] == "no CUDA device"
    assert trep["platform"] == "cpu" and trep["ranking"] == "est_time"
    assert trep["n_units"] == len(trep["units"]) >= 2
    assert 0 < trep["est_step_mfu_ceiling"] <= 1
    assert trep["memory"]["device"] == "cpu"
    # the step still trains after the inspection
    assert np.isfinite(float(ts(tx, ty)))


def test_registry_metrics_move_as_jax():
    (js, jx, jy), (ts, tx, ty) = _tiny_steps()
    for rep_of, reg in ((lambda: jinspect.inspect_step(js, jx, jy),
                         jtel.REGISTRY),
                        (lambda: tinspect.inspect_step(ts, tx, ty),
                         ttel.REGISTRY)):
        before = reg.snapshot()
        rep = rep_of()
        snap = reg.snapshot()
        assert snap["inspect.runs"] == before.get("inspect.runs", 0) + 1
        assert snap["inspect.units"] == before.get("inspect.units", 0) \
            + rep["n_units"]
        assert snap["inspect.top1_share"] == rep["offender_top1_share"]
        assert snap["inspect.memory_bound_byte_share"] == \
            rep["memory_bound_byte_share"]
        assert snap["inspect.mfu_ceiling"] == rep["est_step_mfu_ceiling"]
        assert snap.get('span.count{name="inspect.analyze"}', 0) >= 1
    jnames = {n for n in jtel.REGISTRY.names() if n.startswith("inspect.")}
    tnames = {n for n in ttel.REGISTRY.names() if n.startswith("inspect.")}
    assert tnames == jnames


def test_render_markdown_headers_as_jax(tmp_path):
    (js, jx, jy), (ts, tx, ty) = _tiny_steps()
    jtext = jinspect.render_markdown(jinspect.inspect_step(js, jx, jy,
                                                           name="md"))
    ttext = tinspect.render_markdown(tinspect.inspect_step(ts, tx, ty,
                                                           name="md"))
    for prefix in ("# Offender attribution — md", "Roofline: peak",
                   "Program: ", "MFU ceiling for this fusion structure",
                   "## Offender classes", "## Worst individual kernel units",
                   "| # | fusion class | op | n | bound | GFLOP | MB | "
                   "FLOP/B | time share |",
                   "| # | unit | op | bound | GFLOP | MB | FLOP/B | "
                   "time share | source op |"):
        assert any(line.startswith(prefix) for line in jtext.splitlines())
        assert any(line.startswith(prefix) for line in ttext.splitlines()), \
            prefix
    assert "device ms" in ttext and "roofline share" in ttext


def test_dump_json_is_atomic(tmp_path):
    rep = tinspect.inspect_step(lambda a: (a @ a).sum(), torch.ones(8, 8))
    out = tmp_path / "rep.json"
    tinspect.dump_json(rep, str(out))
    assert json.loads(out.read_text())["n_units"] == rep["n_units"]
    assert sorted(os.listdir(tmp_path)) == ["rep.json"]


def test_top_k_env_knob():
    os.environ["MXNET_INSPECT_TOP_K"] = "2"
    rep = tinspect.inspect_step(
        lambda a: (a @ a).relu().sum() + a.mean(), torch.ones(8, 8))
    assert rep["top_k"] == 2
    assert len(rep["offenders"]) <= 2 and len(rep["offender_groups"]) <= 2
    assert rep["totals"]["units"] == rep["n_units"] > 2


def test_lowering_entry_points_raise():
    for fn in (lambda: tinspect.lower_any(object()),
               lambda: tinspect.inspect_compiled(object()),
               lambda: tinspect.inspect_hlo_text("HloModule m"),
               lambda: tinspect.cost_analysis_summary(object())):
        with pytest.raises(MXNetError, match="lowers no program"):
            fn()
    with pytest.raises(MXNetError):
        tinspect.inspect_step(object())


def test_estimator_and_exported_model_steps(tmp_path):
    from incubator_mxnet_tpu_torch import deploy
    net = tgluon.nn.Dense(3, in_units=6)
    net.initialize(device="cpu")
    x = torch.ones(4, 6)
    y = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    est = test.Estimator(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                         trainer=tgluon.Trainer(net.collect_params(), "sgd",
                                                {"learning_rate": 0.1}))
    weight = net.collect_params()["weight"]
    before = weight.data().clone()
    rep = tinspect.inspect_step(est, x, y)
    assert rep["name"] == "estimator_step" and rep["n_units"] >= 3
    assert {"aten::addmm", "aten::mm"} & {u["opcode"] for u in rep["units"]}
    assert not torch.equal(before, weight.data())   # it trained
    net(x)
    prefix = str(tmp_path / "net")
    net.export(prefix, example_inputs=x)
    model = deploy.ExportedModel(f"{prefix}-0000", device="cpu")
    rep = tinspect.inspect_step(model)
    assert rep["name"] == "exported_model" and rep["n_units"] >= 1
    assert rep["window"]["calls"] == 3


# ---------------------------------------------------------------------------
# class names, attribution, the L2 model, folding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["multiply_multiply_fusion.18.clone",
                                  "loop_add_fusion.remat.3", "dot.1",
                                  "fusion"])
def test_class_name_as_jax_on_hlo_names(name):
    assert treport.class_name(name) == jreport.class_name(name)


@pytest.mark.parametrize("symbol,cls", [
    ("void (anonymous namespace)::scale_shift_act_kernel<__nv_bfloat16, 8, "
     "true>(__nv_bfloat16 const*, float const*, float const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, long, int)",
     "scale_shift_act_kernel"),
    ("void (anonymous namespace)::scale_shift_act_kernel<float, 4, false>("
     "float const*, float const*, float const*, float const*, float*, "
     "long, int)", "scale_shift_act_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_"
     "kernel__5x_cudnn",
     "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
     "optimized_bf16_128x128_32x4_nhwc_align8>(cutlass_tensorop_bf16_"
     "s16816fprop_optimized_bf16_128x128_32x4_nhwc_align8::Params)",
     "cutlass__5x_cudnn::Kernel"),
    ("nvjet_tst_128x256_64x4_2x1_v_ssched_bz_coopA_TNN", "nvjet_tst"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_class_name_folds_cuda_instances(symbol, cls):
    assert treport.class_name(symbol) == cls


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def test_device_records_go_to_the_span_holding_their_launch():
    events = [
        _x("user_annotation", "mx_unit:0", 100, 50, 1),
        _x("cpu_op", "aten::mm", 101, 40, 1),
        _x("user_annotation", "mx_kernel:0", 200, 10, 1),
        _x("user_annotation", "mx_unit:1", 300, 40, 2),
        _x("gpu_user_annotation", "mx_unit:0", 250, 500, 9),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 2, 1, correlation=11),
        _x("cuda_runtime", "cudaMemcpyAsync", 120, 2, 1, correlation=12),
        _x("cuda_runtime", "cudaLaunchKernelExC", 205, 2, 1,
           correlation=13),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 2, 2, correlation=14),
        _x("cuda_runtime", "cudaLaunchKernel", 260, 2, 1, correlation=15),
        _x("kernel", "void foo<float>(float*)", 400, 5, 9, correlation=11),
        _x("gpu_memcpy", "Memcpy DtoD", 406, 2, 9, correlation=12),
        _x("kernel", "scale_shift_act_kernel", 410, 7, 9, correlation=13),
        _x("kernel", "bar", 420, 3, 9, correlation=14),
        _x("kernel", "loose", 430, 4, 9, correlation=15),
        _x("gpu_memset", "Memset (Device)", 440, 1, 9, correlation=16),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 11, "ts": 110},
    ]
    owned, loose = treport._attribute(events)
    assert owned == {("unit", 0): [("void foo<float>(float*)", 5.0),
                                   ("Memcpy DtoD", 2.0)],
                     ("kernel", 0): [("scale_shift_act_kernel", 7.0)],
                     ("unit", 1): [("bar", 3.0)]}
    assert loose == [("loose", 4.0), ("Memset (Device)", 1.0)]


def _rec(op, call, nbytes, sig=()):
    cost = {"flops": 0.0, "bytes": float(nbytes), "in_bytes": None,
            "out_bytes": None, "compute": "float32"}
    return {"op": op, "overload": op, "call": call, "sig": sig,
            "cost": cost}


MB = 1e6


@pytest.mark.parametrize("flops,nbytes,level,seconds", [
    # under twice the L2's size: the L2's rate bounds it, device memory not
    (0.0, 30 * MB, "L2", 30 * MB / 5e12),
    # past it: what the L2 cannot hold goes through device memory
    (0.0, 400 * MB, "device memory", (400 * MB - 2 * 50 * 2 ** 20) / 3.35e12),
    # enough float32 operations: the peak of the type bounds it
    (1e9, 30 * MB, "operations", 1e9 / 67e12),
])
def test_floor_is_the_slowest_level_and_never_above_the_cold_bound(
        flops, nbytes, level, seconds):
    calib = dict(troofline.load_calibration(platform="gpu"),
                 l2_bytes_per_sec=5e12)
    cost = {"flops": flops, "bytes": nbytes, "compute": "float32"}
    sec, by = troofline.floor_bound(cost, calib)
    assert by == level and sec == pytest.approx(seconds, rel=1e-12)
    assert sec <= troofline.unit_bound(cost, calib)[0]


def test_a_calibration_without_the_l2_takes_the_platform_rows():
    row = troofline.DEFAULT_CALIBRATIONS["cpu"]
    calib = treport._with_l2({"peak_flops": 1e12,
                              "peak_bytes_per_sec": 1e11},
                             torch.device("cpu"))
    assert (calib["l2_bytes"], calib["l2_bytes_per_sec"]) == (
        row["l2_bytes"], row["l2_bytes_per_sec"])
    # the card's row leaves the rate to a measurement on the card
    assert troofline.DEFAULT_CALIBRATIONS["gpu"]["l2_bytes_per_sec"] is None


def test_report_floor_shares_use_a_known_l2_rate():
    calib = dict(troofline.load_calibration(platform="cpu"),
                 l2_bytes_per_sec=4e11)
    rep = treport.inspect_step(torch.add, torch.ones(64, 64),
                               torch.ones(64, 64), steps=1, calib=calib)
    (u,) = rep["units"]
    assert rep["calibration"]["l2_bytes_per_sec"] == 4e11
    assert u["floor_time_s"] == u["bytes"] / 4e11 and u["floor_by"] == "L2"
    assert u["floor_share"] is None and rep["l2_resident"] == {
        "over_cold_bound": 0, "units": []}


def test_launch_sites_fold_over_calls_that_differ():
    sig = lambda n: ((((n,), "torch.float32"),))  # noqa: E731
    records = [
        _rec("mul", 0, 100, sig(1)),
        _rec("copy_", 0, 50, sig(2)),
        _rec("add", 0, 80, sig(3)),
        _rec("mul", 1, 100, sig(1)),
        _rec("add", 1, 80, sig(3)),
    ]
    owned = {("unit", 0): [("k", 4.0)], ("unit", 3): [("k", 6.0)],
             ("unit", 1): [("c", 2.0)]}
    units = treport._units(records, [], owned, 2, measured=True)
    by = {u["opcode"]: u for u in units}
    # measured: "add" launched nothing on the card, so it is no unit
    assert [u["opcode"] for u in units] == ["mul", "copy_"]
    assert by["mul"]["calls"] == 2 and by["mul"]["device_us"] == 5.0
    assert by["copy_"]["calls"] == 1 and by["copy_"]["cost"]["bytes"] == 25
    assert by["copy_"]["device_us"] == 1.0
    unmeasured = treport._units(records, [], {}, 2, measured=False)
    assert [(u["opcode"], u["calls"]) for u in unmeasured] == [
        ("mul", 2), ("copy_", 1), ("add", 2)]


def test_capture_notes_launches_only_while_an_inspection_runs():
    calls = []

    def lib_entry(*args):
        calls.append(args)
        return 0
    assert kernels._CAPTURE is None
    kernels._CAPTURE = cap = []
    try:
        launch = kernels._captured(lib_entry, "scale_shift_act", M=4, C=8,
                                   dtype=torch.float32)
        assert launch(1, 2) == 0
    finally:
        kernels._CAPTURE = None
    assert calls == [(1, 2)]
    (name, shape), = cap
    assert name == "scale_shift_act" and shape["M"] == 4
    # inspect_step leaves no capture behind, even when the step raises in
    # the window (its second call: the first warms up)
    n = []

    def fails_second():
        n.append(1)
        return 1 / (2 - len(n))
    with pytest.raises(ZeroDivisionError):
        tinspect.inspect_step(fails_second, device="cpu")
    assert len(n) == 2
    assert kernels._CAPTURE is None


# ---------------------------------------------------------------------------
# kernel_cost against PERF.md section 6's bound column
# ---------------------------------------------------------------------------
S, H, D, T = 16, 12, 64, 2048


def _phase2_lens():
    rng = np.random.RandomState(0)
    return np.concatenate([[0, 1, 255, 1000, 2047],
                           rng.randint(0, T, S - 5)]).astype(np.int32)


def _phase8_lens(C):
    rng = np.random.RandomState(8)
    for c in (1, 4, 256):
        lens = np.concatenate([[0, 1, 255, 1000, T - c],
                               rng.randint(0, T - c, S - 5)]).astype(
                                   np.int32)
        if c == C:
            return lens


bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
PERF_ROWS = [
    # (row, kernel, shape, bound ms, bound by)
    ("B1 stem f32", "scale_shift_act",
     dict(M=32 * 112 * 112, C=64, dtype=f32), 0.0613, "bytes"),
    ("B1 stem f16", "scale_shift_act",
     dict(M=32 * 112 * 112, C=64, dtype=f16), 0.0307, "bytes"),
    ("B1 SSD conv1", "scale_shift_act",
     dict(M=2_880_000, C=64, dtype=bf16, act="relu", scale=False),
     0.2201, "bytes"),
    ("B1 v2 C=3", "scale_shift_act",
     dict(M=32 * 224 * 224, C=3, dtype=f32), 0.0115, "bytes"),
    ("B2 global", "avg_pool2d_fwd",
     dict(N=32, H=7, W=7, C=2048, ph=7, pw=7, dtype=bf16), 0.0020, "bytes"),
    ("B2 2x2", "avg_pool2d_fwd",
     dict(N=32, H=56, W=56, C=256, ph=2, pw=2, dtype=bf16), 0.0192,
     "bytes"),
    ("B3 global", "avg_pool2d_bwd",
     dict(N=32, H=7, W=7, C=2048, ph=7, pw=7, dtype=bf16), 0.0020, "bytes"),
    ("B3 2x2", "avg_pool2d_bwd",
     dict(N=32, H=56, W=56, C=256, ph=2, pw=2, dtype=bf16), 0.0192,
     "bytes"),
    ("B4 split bf16 C=1", "paged_attention",
     dict(lengths=_phase2_lens(), C=1, T=T, H=H, D=D, dtype=bf16), 0.0140,
     "bytes"),
    ("B4 split bf16 C=4", "paged_attention",
     dict(lengths=_phase2_lens(), C=4, T=T, H=H, D=D, dtype=bf16), 0.0140,
     "bytes"),
    ("B4 split int8 C=4", "paged_attention_int8",
     dict(lengths=_phase8_lens(4), C=4, T=T, H=H, D=D, dtype=bf16,
          kv_dtype=torch.int8), 0.0067, "bytes"),
    ("B4 split f32 C=1", "paged_attention",
     dict(lengths=_phase2_lens(), C=1, T=T, H=H, D=D, dtype=f32), 0.0279,
     "bytes"),
    ("B4 wgmma bf16 C=256", "paged_attention",
     dict(lengths=_phase2_lens(), C=256, T=T, H=H, D=D, dtype=bf16),
     0.0212, "bytes"),
    ("B4 wgmma int8 C=256", "paged_attention_int8",
     dict(lengths=_phase8_lens(256), C=256, T=T, H=H, D=D, dtype=bf16,
          kv_dtype=torch.int8), 0.0115, "operations"),
    ("B5", "flash_fwd", dict(bh=192, tq=512, tk=512, d=64, causal=False,
                             dtype=bf16), 0.0150, "bytes"),
    ("B5 causal", "flash_fwd", dict(bh=48, tq=2048, tk=2048, d=128,
                                    causal=True, dtype=bf16), 0.0521,
     "operations"),
    ("B6", "flash_fwd_lse", dict(bh=192, tq=512, tk=512, d=64, causal=False,
                                 dtype=bf16), 0.0151, "bytes"),
    ("B7", "flash_bwd_dq", dict(bh=192, tq=512, tk=512, d=64, causal=False,
                                dtype=bf16), 0.0195, "operations"),
    ("B7 causal", "flash_bwd_dq", dict(bh=48, tq=2048, tk=2048, d=128,
                                       causal=True, dtype=bf16), 0.0782,
     "operations"),
    ("B8", "flash_bwd_dkv", dict(bh=192, tq=512, tk=512, d=64, causal=False,
                                 dtype=bf16), 0.0261, "operations"),
    ("B8 causal", "flash_bwd_dkv", dict(bh=48, tq=2048, tk=2048, d=128,
                                        causal=True, dtype=bf16), 0.1043,
     "operations"),
    ("NMS (32, 8732)", "nms_sweep",
     dict(B=32, A=8732, iou_tests=30_070_329), 0.0085, "operations"),
    ("augment", "image_augment",
     dict(N=32, ch=224, cw=224, in_dtype=torch.uint8, out_dtype=bf16),
     0.0043, "bytes"),
    ("augment batch 256", "image_augment",
     dict(N=256, ch=224, cw=224, in_dtype=torch.uint8, out_dtype=bf16),
     0.0345, "bytes"),
    ("augment f32 out", "image_augment",
     dict(N=32, ch=224, cw=224, in_dtype=torch.uint8, out_dtype=f32),
     0.0072, "bytes"),
    ("augment int16", "image_augment",
     dict(N=32, ch=224, cw=224, in_dtype=torch.int16, out_dtype=bf16),
     0.0058, "bytes"),
]


@pytest.mark.parametrize("row,kernel,shape,bound,by", PERF_ROWS,
                         ids=[r[0] for r in PERF_ROWS])
def test_kernel_cost_reproduces_the_perf_table(row, kernel, shape, bound,
                                               by):
    calib = troofline.load_calibration(platform="gpu")
    cost = troofline.kernel_cost(kernel, **shape)
    sec, got_by, _, _ = troofline.unit_bound(cost, calib)
    assert round(sec * 1e3, 4) == bound, (row, sec * 1e3)
    assert got_by == by, row


def test_kernel_cost_flags_an_nms_launch_it_cannot_count():
    cost = troofline.kernel_cost("nms_sweep", B=32, A=8732)
    assert cost["bytes_only"] and cost["flops"] == 0
    assert cost["bytes"] == 32 * 8732 * (16 + 4 + 2)
    with pytest.raises(MXNetError, match="no kernel"):
        troofline.kernel_cost("no_such_kernel")


def test_kernel_cost_formulas():
    c = troofline.kernel_cost("scale_shift_act", M=10, C=4, dtype=bf16,
                              act="gelu", residual=True)
    assert c["flops"] == 10 * 4 * (2 + 1 + 8)
    assert c["bytes"] == 10 * 4 * 2 * 3 + 2 * 4 * 4
    assert c["compute"] == "float32"
    c = troofline.kernel_cost("flash_fwd", bh=1, tq=3, tk=5, d=2,
                              causal=True, dtype=f32)
    # end-aligned causal: query i sees keys j <= i + 2 -> 3 + 4 + 5 pairs
    assert c["flops"] == 12 * 2 * 2 * 2 and c["compute"] == "float32"
    c = troofline.kernel_cost("paged_attention", lengths=[0, 3], C=2, T=4,
                              H=1, D=2, dtype=bf16, kv_dtype=f32)
    assert c["compute"] == "float32"      # the slower type bounds it
    assert c["flops"] == (1 + 2 + 4 + 4) * 1 * 2 * 4


# ---------------------------------------------------------------------------
# the command-line tool
# ---------------------------------------------------------------------------
def test_torch_offenders_cli_json_smoke():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "tools/torch_offenders.py",
                        "--device", "cpu", "--model", "resnet18", "--batch",
                        "2", "--json", "-"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout)
    assert rep["name"] == "resnet18_train_bs2"
    assert rep["platform"] == "cpu" and rep["measured"] is False
    assert rep["n_units"] > 100 and rep["n_groups"] > 5
    assert rep["totals"]["flops"] > 0
    classes = {g["class"] for g in rep["offender_groups"]}
    assert "aten::convolution_backward" in classes
