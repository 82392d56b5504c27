"""mx.inspect.roofline of the PyTorch port: the roofline cost model.

Counterpart of `incubator_mxnet_tpu/inspect/roofline.py` without HLO: the
port lowers no program, so a unit of work is one launch site of a real
call (see `inspect.report`), and this module models each one:

  flops       a multiply-add counts 2 (the convention of every peak and
              MFU number in the repo). An aten op's flops are
              `torch.utils.flop_counter`'s formulas (the table
              `FlopCounterMode` counts by: products, convolutions and
              their backward, attention); an op outside that table counts
              0. A hand-written kernel's flops are `kernel_cost`'s.
  bytes       each input read once and each output written once.
  intensity   flops / bytes (FLOP/B).
  class       compute-bound at or above the ridge point of the unit's own
              compute type (that type's peak over the memory rate),
              memory-bound below it.
  est_time_s  max(flops / the type's peak, bytes / the memory rate): the
              least time the card could take for the unit when every byte
              comes from and goes to device memory (the cold bound).
  floor       the least time even where the L2 serves inputs or holds
              outputs (`floor_bound`): the slowest of three levels working
              at once: the flops over the type's peak; every byte through
              the L2 over the L2's rate; over device memory, all but what
              the L2 can hold (its size of the inputs when the unit
              starts, its size of the outputs, not yet written back, when
              it ends).

Peaks come from `DEFAULT_CALIBRATIONS` (the card's published dense rates)
unless a calibration file is named (`load_calibration`). The JAX package's
committed TPU calibration artifact is not read: no TPU figure is the
port's.
"""
from __future__ import annotations

import json

import torch

from ..base import MXNetError, get_env

__all__ = ["classify", "load_calibration", "callable_cost", "kernel_cost",
           "unit_bound", "floor_bound", "measure_l2_rate", "peak_for", "aten_cost", "KERNELS",
           "cost_analysis_summary", "CALIB_PATH", "DEFAULT_CALIBRATIONS"]

# A calibration file read when no path is passed and MXNET_INSPECT_CALIB is
# unset, under the platform guard. None: the port commits no calibration
# artifact, so the spec table below decides.
CALIB_PATH = None

# Spec rows by platform. "gpu": NVIDIA's data sheet for the H100 SXM5 (80 GB
# HBM3), dense rates without sparsity, at its 700 W power limit (a card
# set below it runs slower under load): 989e12 FLOP/s in bfloat16 and
# float16 on the tensor cores, 495e12 in TF32, 67e12 in float32 outside
# the tensor cores, 3.35e12 bytes/s of device memory, a 50 MB L2. The
# L2's rate is on no data sheet: None here, so `inspect_step` measures it
# on the card (`measure_l2_rate`). `peak_flops` is the bfloat16 rate (the
# MFU denominator). "cpu": modest figures so that a report on the host
# classifies its units sanely; they are no measurement.
DEFAULT_CALIBRATIONS = {
    "gpu": {"name": "NVIDIA H100 SXM5 80GB (data sheet, dense, 700 W)",
            "peak_flops": 989e12,
            "peak_flops_by_type": {"bfloat16": 989e12, "float16": 989e12,
                                   "tf32": 495e12, "float32": 67e12},
            "peak_bytes_per_sec": 3.35e12,
            "l2_bytes": 50 * 2 ** 20, "l2_bytes_per_sec": None,
            "source": "spec-fallback"},
    "cpu": {"name": "host CPU (nominal)",
            "peak_flops": 1.0e11, "peak_bytes_per_sec": 20e9,
            "l2_bytes": 32 * 2 ** 20, "l2_bytes_per_sec": 100e9,
            "source": "spec-fallback"},
}


def classify(intensity, ridge):
    """'compute' at or above the ridge point (FLOP/B), 'memory' below it."""
    return "compute" if intensity >= ridge else "memory"


def _ambient_platform(default="cpu"):
    return "gpu" if torch.cuda.is_available() else default


def load_calibration(path=None, platform=None):
    """Resolve the roofline peaks: an explicit path, then
    MXNET_INSPECT_CALIB (both trusted whatever platform they name), then
    `CALIB_PATH` when set (skipped when its `platform` is another one: the
    platform guard), then the platform's row of `DEFAULT_CALIBRATIONS`.
    Unreadable or incomplete files are skipped. Returns a dict with at
    least `peak_flops`, `peak_bytes_per_sec`, `ridge_flop_per_byte` and
    `source`."""
    if platform is None:
        platform = _ambient_platform()
    candidates = []
    if path:
        candidates.append((path, True))
    envp = get_env("MXNET_INSPECT_CALIB", None, typ=str)
    if envp:
        candidates.append((envp, True))
    if CALIB_PATH:
        candidates.append((CALIB_PATH, False))
    calib = None
    for cand, explicit in candidates:
        try:
            with open(cand) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if not (data.get("peak_flops") and data.get("peak_bytes_per_sec")):
            continue
        if not explicit and data.get("platform") \
                and data["platform"] != platform:
            continue
        calib = dict(data)
        calib.setdefault("source", cand)
        break
    if calib is None:
        calib = json.loads(json.dumps(DEFAULT_CALIBRATIONS.get(
            platform, DEFAULT_CALIBRATIONS["cpu"])))
    calib["ridge_flop_per_byte"] = (
        float(calib["peak_flops"]) / float(calib["peak_bytes_per_sec"]))
    return calib


def peak_for(calib, compute):
    """The peak FLOP/s of compute type `compute` ("bfloat16", "float16",
    "tf32", "float32", or None) in `calib`: its own row where the
    calibration has one, else `peak_flops`."""
    return float(calib.get("peak_flops_by_type", {}).get(
        compute, calib["peak_flops"]))


def unit_bound(cost, calib):
    """(least seconds, "bytes" or "operations", flops seconds, bytes
    seconds) of a unit whose `cost` has `flops`, `bytes` and `compute`,
    cold: all its bytes over the memory rate, its flops over its type's
    peak."""
    t_flops = cost["flops"] / peak_for(calib, cost.get("compute"))
    t_bytes = cost["bytes"] / float(calib["peak_bytes_per_sec"])
    return (max(t_flops, t_bytes),
            "bytes" if t_bytes >= t_flops else "operations", t_flops, t_bytes)


def floor_bound(cost, calib):
    """(least seconds, level) of a unit whatever the L2 holds: the slowest
    of its flops over its type's peak ("operations"), every byte through
    the L2 over the L2's rate ("L2"), and over the memory rate the bytes
    the L2 cannot spare device memory ("device memory": at most its size
    of the inputs can be there when the unit starts, and at most its size
    of the outputs can wait there, unwritten, when it ends). At most the
    cold bound while the L2 outruns device memory."""
    t_flops = cost["flops"] / peak_for(calib, cost.get("compute"))
    t_hbm = max(0.0, cost["bytes"] - 2 * float(calib["l2_bytes"])) \
        / float(calib["peak_bytes_per_sec"])
    t_l2 = cost["bytes"] / float(calib["l2_bytes_per_sec"])
    return max((t_flops, "operations"), (t_hbm, "device memory"),
               (t_l2, "L2"), key=lambda p: p[0])


def measure_l2_rate(device):
    """The L2's rate on the card, bytes/s: the most that PyTorch's
    elementwise and reduction kernels move over tensors that stay in the
    L2 (an add over three tensors of 2, 4 and 8 MiB each, a copy over two,
    a sum over one, each launched 20 times so that all but the first find
    their tensors there), each launch's bytes (inputs read, outputs
    written) over its device time in a `torch.profiler` trace."""
    from torch.profiler import ProfilerActivity, profile
    from .report import _trace_events
    device = torch.device(device)
    runs = []
    for mib in (2, 4, 8):
        n = mib * 2 ** 20 // 4
        a, b, c = (torch.rand(n, device=device) for _ in range(3))
        out = torch.empty((), device=device)
        runs += [(lambda a=a, b=b, c=c: torch.add(a, b, out=c), 3 * n * 4),
                 (lambda a=a, c=c: c.copy_(a), 2 * n * 4),
                 (lambda a=a, o=out: torch.sum(a, dim=0, out=o), n * 4 + 4)]
    best = 0.0
    for fn, nbytes in runs:
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize(device)
        durs = [float(e["dur"]) for e in _trace_events(prof)
                if e.get("ph") == "X" and e.get("cat") == "kernel"
                and e.get("dur")]
        if durs:
            best = max(best, nbytes / (min(durs) * 1e-6))
    if not best:
        raise MXNetError("measure_l2_rate: the profiler recorded no kernel")
    return best


# ---------------------------------------------------------------------------
# the hand-written kernels: flops and bytes of one launch
# ---------------------------------------------------------------------------
def _name(dtype):
    return str(dtype).replace("torch.", "")


def _item(dtype):
    return torch.empty((), dtype=dtype).element_size()


# per element of the apply kernel: the f32 operations of each activation
# (relu a max; sigmoid and tanh an exponential and a division; silu one
# more product; gelu's erf form)
ACT_OPS = {None: 0, "relu": 1, "sigmoid": 4, "tanh": 4, "silu": 5,
           "gelu": 8}
# products per (query, key) pair, each 2 * d operations: q.k and p.v in the
# forward; q.k, dO.v and ds.k in the dq sweep; q.k, dO.v, p.dO and ds.q in
# the dk/dv sweep
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_fwd_lse": 2, "flash_bwd_dq": 3,
                  "flash_bwd_dkv": 4}
# float32 operations of one IoU test in the sweep (2 max, 2 min, 2 sub, 2
# clamps, a product; the later box's area: 2 sub, 2 clamps, a product; the
# union's add and sub; the quotient; the comparison)
IOU_OPS = 19
# float32 operations of one output element of the augment (scale, mean,
# std, cast)
AUGMENT_OPS = 4


def _scale_shift_act(M, C, dtype, act=None, residual=False, scale=True,
                     shift=True):
    item = _item(dtype)
    rows = int(bool(scale)) + int(bool(shift))
    return {"flops": M * C * (rows + int(bool(residual)) + ACT_OPS[act]),
            "bytes": M * C * item * (3 if residual else 2) + rows * C * 4,
            "compute": "float32"}


def _pool(N, H, W, C, ph, pw, dtype):
    n_in, n_out = N * H * W * C, N * (H // ph) * (W // pw) * C
    return {"flops": max(n_in, n_out), "bytes": (n_in + n_out) * _item(dtype),
            "compute": "float32"}


def live_pairs(tq, tk, causal):
    """(query, key) pairs a head attends: all, or the end-aligned causal
    triangle (query i sees keys j <= i + tk - tq)."""
    if not causal:
        return tq * tk
    return sum(max(0, min(tk, i + tk - tq + 1)) for i in range(tq))


def _flash(name):
    def cost(bh, tq, tk, d, causal, dtype):
        item = _item(dtype)
        nq, nk, rows = bh * tq * d * item, bh * tk * d * item, bh * tq * 4
        nbytes = {"flash_fwd": 2 * nq + 2 * nk,
                  "flash_fwd_lse": 2 * nq + 2 * nk + rows,
                  "flash_bwd_dq": 3 * nq + 2 * nk + 2 * rows,
                  "flash_bwd_dkv": 2 * nq + 4 * nk + 2 * rows}[name]
        return {"flops": bh * live_pairs(tq, tk, causal) * 2 * d
                * FLASH_PRODUCTS[name], "bytes": nbytes,
                "compute": _name(dtype)}
    return cost


_PEAK_RANK = {"bfloat16": 2, "float16": 2, "tf32": 1, "float32": 0}


def _paged(lengths, C, T, H, D, dtype, kv_dtype=None):
    kv_dtype = kv_dtype or dtype
    lens = [int(n) for n in (lengths.tolist() if hasattr(lengths, "tolist")
                             else lengths)]
    item, kv_item = _item(dtype), _item(kv_dtype)
    S = len(lens)
    live = sum(min(T, n + C) for n in lens)
    nbytes = 2 * S * C * H * D * item + 4 * S + live * H * D * 2 * kv_item
    if kv_dtype == torch.int8:
        nbytes += live * 2 * 4
    # query j of lane s attends over min(T, len + j + 1) positions, each 2 *
    # D multiply-adds (q.k and p.v), 2 operations each
    flops = sum(min(T, n + j + 1) for n in lens for j in range(C)) * H * D * 4
    # the slower of q's type and the slab's (an int8 slab computes in q's)
    compute = _name(dtype)
    if kv_dtype != torch.int8 and \
            _PEAK_RANK.get(_name(kv_dtype), 2) < _PEAK_RANK.get(compute, 2):
        compute = _name(kv_dtype)
    return {"flops": flops, "bytes": nbytes, "compute": compute}


def _nms(B, A, iou_tests=None, ids=True):
    nbytes = B * A * 4 * 4 + (B * A * 4 if ids else 0) + 2 * B * A
    out = {"flops": IOU_OPS * iou_tests if iou_tests is not None else 0,
           "bytes": nbytes, "compute": "float32"}
    if iou_tests is None:
        # the tests a sweep needs depend on what it keeps: a launch cannot
        # tell them, so its bound counts the bytes only
        out["bytes_only"] = True
    return out


def _augment(N, ch, cw, in_dtype, out_dtype, cr=3, cout=3):
    return {"flops": AUGMENT_OPS * N * ch * cw * cout,
            "bytes": N * ch * cw * (cr * _item(in_dtype)
                                    + cout * _item(out_dtype)),
            "compute": "float32"}


# kernel (launch counter's name) -> cost of one launch from its shapes
KERNELS = {
    "scale_shift_act": _scale_shift_act,
    "avg_pool2d_fwd": _pool,
    "avg_pool2d_bwd": _pool,
    "paged_attention": _paged,
    "paged_attention_int8": _paged,
    "flash_fwd": _flash("flash_fwd"),
    "flash_fwd_lse": _flash("flash_fwd_lse"),
    "flash_bwd_dq": _flash("flash_bwd_dq"),
    "flash_bwd_dkv": _flash("flash_bwd_dkv"),
    "nms_sweep": _nms,
    "image_augment": _augment,
}


def kernel_cost(name, **shape):
    """Flops and bytes of one launch of the port's hand-written kernel
    `name` (a launch counter's name in `ops.kernels`) at `shape`, each input
    read once and each output written once, a multiply-add as 2:

      scale_shift_act  M, C, dtype, act=None, residual=False, scale=True,
                       shift=True (x and the residual read, the output
                       written, the f32 scale / shift rows read; f32 ops)
      avg_pool2d_fwd / avg_pool2d_bwd
                       N, H, W, C, ph, pw, dtype (H, W: the pooled-over
                       size; one f32 op an element read)
      paged_attention  lengths, C, T, H, D, dtype, kv_dtype=dtype (q read
                       and out written, each lane's live K/V read once at
                       its real length, int8 scales; the products the
                       lengths need)
      flash_*          bh, tq, tk, d, causal, dtype (q, k, v, o, dO, dq,
                       dk, dv in dtype, lse and delta f32; each live pair
                       once)
      nms_sweep        B, A, iou_tests=None, ids=True (boxes, ids and the
                       keep mask in and out; 19 f32 ops an IoU test the
                       inputs need, or bytes only, flagged, when unknown)
      image_augment    N, ch, cw, in_dtype, out_dtype, cr=3, cout=3 (the
                       crop's cr channels read, cout written)

    Returns {"name", "flops", "bytes", "compute"} (the type whose peak
    bounds the operations), plus "bytes_only" when the flops are unknown.
    """
    fn = KERNELS.get(name)
    if fn is None:
        raise MXNetError(f"kernel_cost: no kernel named {name!r}; known: "
                         f"{sorted(KERNELS)}")
    out = fn(**shape)
    out["flops"] = float(out["flops"])
    out["bytes"] = float(out["bytes"])
    out["name"] = name
    return out


# ---------------------------------------------------------------------------
# aten ops: flops by torch.utils.flop_counter's formulas, bytes by tensors
# ---------------------------------------------------------------------------
_PRODUCTS = frozenset(("mm", "addmm", "bmm", "baddbmm", "convolution",
                       "_convolution", "cudnn_convolution",
                       "convolution_overrideable", "convolution_backward",
                       "_slow_conv2d_forward"))


def _tensors(tree):
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
    walk(tree)
    return out


def _tensor_bytes(t):
    """Bytes a kernel reads or writes of `t`: its elements, or its
    storage's bytes where fewer (an expanded or broadcast view reads its
    storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _compute_type(op, tensors):
    floats = [t for t in tensors if t.is_floating_point()]
    if not floats:
        return None
    name = _name(floats[0].dtype)
    if name == "float32" and op in _PRODUCTS and floats[0].is_cuda:
        conv = "conv" in op
        tf32 = (torch.backends.cudnn.allow_tf32 if conv
                else torch.backends.cuda.matmul.allow_tf32)
        if tf32:
            return "tf32"
    return name if name in _PEAK_RANK else "float32"


# in-place ops that write their first argument without reading it
_WRITE_ONLY = frozenset(("copy_", "fill_", "zero_", "normal_", "uniform_",
                         "random_", "exponential_", "bernoulli_",
                         "geometric_", "log_normal_", "cauchy_", "set_"))
# ops that take a tensor for its shape, type and device alone
_SHAPE_ONLY = frozenset(("zeros_like", "ones_like", "full_like", "rand_like",
                         "randn_like", "randint_like", "new_zeros",
                         "new_ones", "new_full"))


def aten_cost(func, args, kwargs, out):
    """Cost of one aten op call: flops by `torch.utils.flop_counter`'s
    formula for the op (0 for an op outside its table), bytes of each
    distinct input tensor read once plus each output written once (an
    `out=` tensor, the first argument of an op that only overwrites it,
    `copy_`, `fill_`, `zero_` or a random fill, and the tensors a
    `zeros_like`-style factory takes for their shape are not read), and the
    compute type of its first floating-point input (float32 products on
    the card as TF32 where PyTorch allows TF32 for them)."""
    from torch.utils.flop_counter import flop_registry
    packet = getattr(func, "_overloadpacket", func)
    kwargs = kwargs or {}
    flops = 0.0
    formula = flop_registry.get(packet)
    if formula is not None:
        try:
            flops = float(formula(*args, **kwargs, out_val=out))
        except Exception:      # a formula that does not take this overload
            flops = 0.0
    op = getattr(packet, "__name__", str(packet)).split(".")[-1]
    read_args = (() if op in _SHAPE_ONLY
                 else args[1:] if op in _WRITE_ONLY else args)
    ins = _tensors((read_args, {k: v for k, v in kwargs.items()
                                if k != "out"}))
    seen, in_bytes = set(), 0
    for t in ins:
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        if key in seen:            # the same tensor read twice is one read
            continue
        seen.add(key)
        in_bytes += _tensor_bytes(t)
    out_bytes = sum(_tensor_bytes(t) for t in _tensors(out))
    return {"flops": flops, "bytes": float(in_bytes + out_bytes),
            "in_bytes": float(in_bytes), "out_bytes": float(out_bytes),
            "compute": _compute_type(op, _tensors((args, kwargs)))}


def callable_cost(fn, *args, calib=None):
    """Estimated cost of one call `fn(*args)`, which really runs: flops
    counted by `FlopCounterMode`, bytes as the sum of its aten ops' (each
    op's inputs read and outputs written once), their intensity and
    roofline class against the ridge point. The JAX package reads XLA's
    cost analysis of a compiled program instead."""
    from torch.utils.flop_counter import FlopCounterMode
    from .report import _Recorder
    if calib is None:
        calib = load_calibration()
    counter = FlopCounterMode(display=False)
    rec = _Recorder()
    with counter, rec:
        fn(*args)
    flops = float(counter.get_total_flops())
    bytes_ = float(sum(r["cost"]["bytes"] for r in rec.records))
    out = {"est_flops": flops, "est_bytes": bytes_,
           "flops_source": "flop-counter", "bytes_source": "aten-model",
           "bytes_estimated": bytes_ > 0}
    if bytes_:
        intensity = flops / bytes_
        out["intensity"] = round(intensity, 4)
        out["bound"] = classify(intensity, calib["ridge_flop_per_byte"])
    else:
        out["intensity"] = None
        out["bound"] = None
    return out


def cost_analysis_summary(compiled):
    """The JAX package reads XLA's cost analysis of a compiled program;
    the port compiles none."""
    raise MXNetError("cost_analysis_summary: the PyTorch port lowers no "
                     "program to read a cost analysis from; use "
                     "inspect_step or callable_cost over a real call")
