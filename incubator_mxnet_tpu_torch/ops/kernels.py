"""The port's hand-written CUDA kernels: build, load, launch.

Each `csrc/*.cu` source has a plain C interface. At first use it is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under the
package's `_build/` directory (listed in `.gitignore`) and loaded with
`ctypes`. A library is rebuilt when its source, a `csrc/*.cuh` header it
includes, or the flags change: the file name carries a hash of them all. Nothing is compiled or loaded when this
module is imported, so the CPU tests import it on machines without `nvcc`.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
layout, launches on PyTorch's current stream without synchronising, raises
when the launch is refused, and adds one to its launch counter (see
`launch_counts()`). Every shape rule a wrapper enforces is a row of one
table, `refusal()`: it refuses only what the JAX package refuses too. Any
other shape the JAX package serves reaches a kernel, every head dim
included. The plain PyTorch versions live beside the
dispatchers in `ops/fused.py`, `ops/attention.py`, `ops/contrib.py` and
`ops/rnn.py`; no wrapper ever
falls back to them, and no wrapper copies a tensor into the layout its
kernel takes: it raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter

import torch

from ..base import MXNetError

__all__ = ["build", "paged_attention_cuda", "scale_shift_act_cuda",
           "avg_pool2d_fwd_cuda", "avg_pool2d_bwd_cuda", "flash_fwd_cuda",
           "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda", "nms_sweep_cuda",
           "proposal_sweep_cuda", "nms_mask_bytes",
           "image_augment_cuda", "rnn_cell_fwd_cuda", "rnn_cell_bwd_cuda",
           "rnn_cell_vec", "RNN_MODES", "RNN_GATES", "RNN_ACTS",
           "rnn_layer_fwd_cuda", "rnn_layer_bwd_cuda", "rnn_layer_plan",
           "rnn_layer_route", "RNN_LAYER_SMS", "RNN_LAYER_SMEM",
           "flash_fwd_route",
           "flash_bwd_route", "paged_route", "pool_route", "augment_route",
           "augment_channels",
           "ACT_CODES", "DTYPE_CODES", "RULES", "refusal",
           "reset_launch_counts", "launch_counts", "launch_counts_by_dtype"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_SOURCES = ("paged_attention", "scale_shift_act", "avg_pool2d",
            "flash_attention", "nms", "image_augment", "rnn_cell",
            "rnn_layer")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}
# what the last build printed, per source (ptxas register/spill report)
BUILD_LOG = {}
_BUILD_LOG_LOCK = threading.Lock()

# Guards the launch counters below and `_BY_DTYPE`: the batcher, engine
# and fleet threads launch too, and `+=` on a global or a Counter is a
# read-modify-write that loses updates under contention. A lock of their
# own: `_load` holds `_LOCK` across a whole `nvcc` build.
_COUNT_LOCK = threading.Lock()

# launches of each kernel since the last reset: one per successful launch
paged_attention_launches = 0
paged_attention_int8_launches = 0
# the paged launches (of the two above) by route (`paged_route`)
paged_attention_split_launches = 0
paged_attention_wgmma_launches = 0
paged_attention_cuda_cores_launches = 0
scale_shift_act_launches = 0
avg_pool2d_fwd_launches = 0
avg_pool2d_bwd_launches = 0
flash_fwd_launches = 0
flash_fwd_lse_launches = 0
# the forward launches (of the two above) that ran on the tensor cores
flash_fwd_wgmma_launches = 0
flash_fwd_lse_wgmma_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
# the backward launches (of the two above) that ran on the tensor cores
flash_bwd_dq_wgmma_launches = 0
flash_bwd_dkv_wgmma_launches = 0
# the detection tail's greedy NMS sweep (port-only: no TPU kernel)
nms_sweep_launches = 0
# the same kernels under the proposal op's pixel-inclusive IoU
proposal_sweep_launches = 0
# the input path's crop / mirror / normalize / cast (port-only)
image_augment_launches = 0
# the augment launches (of the one above) by route (`augment_route`)
image_augment_table_launches = 0
image_augment_direct_launches = 0
image_augment_scalar_launches = 0
# the recurrent cell's elementwise step, forward and backward (port-only:
# the JAX package's cell body is fused by XLA inside lax.scan)
rnn_cell_fwd_launches = 0
rnn_cell_bwd_launches = 0
# the recurrent layer's whole time loop, forward and backward (port-only:
# the JAX package's lax.scan is one XLA program)
rnn_layer_fwd_launches = 0
rnn_layer_bwd_launches = 0
# the (layer, direction) passes of ops.nn.rnn on the card by route
# (`rnn_layer_route`): one rnn_layer_fwd launch each on "persistent", a
# cell launch a step on "per_step"
rnn_layer_persistent_launches = 0
rnn_layer_per_step_launches = 0
# every launch above again, by (counter name, dtype name of the launch's
# data: x, q, or the slab for the paged kernel's slab side)
_BY_DTYPE = Counter()
# every counter above by name, in `launch_counts()`'s order
_COUNTERS = ("paged_attention", "paged_attention_int8",
             "paged_attention_split", "paged_attention_wgmma",
             "paged_attention_cuda_cores", "scale_shift_act",
             "avg_pool2d_fwd", "avg_pool2d_bwd", "flash_fwd",
             "flash_fwd_lse", "flash_fwd_wgmma", "flash_fwd_lse_wgmma",
             "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_wgmma",
             "flash_bwd_dkv_wgmma", "nms_sweep", "proposal_sweep",
             "image_augment", "image_augment_table", "image_augment_direct",
             "image_augment_scalar", "rnn_cell_fwd", "rnn_cell_bwd",
             "rnn_layer_fwd", "rnn_layer_bwd", "rnn_layer_persistent",
             "rnn_layer_per_step")


def _count_launch(*names):
    """One launch on each counter `<name>_launches` of `names`."""
    g = globals()
    with _COUNT_LOCK:
        for name in names:
            g[name + "_launches"] += 1


def _count_dtype(name, *dtypes):
    with _COUNT_LOCK:
        for dt in dtypes:
            _BY_DTYPE[(name, str(dt).replace("torch.", ""))] += 1


# The launches of a running inspection (`inspect.report.inspect_step`): a
# list of (kernel name, shape) while one runs, else None. A wrapper then
# launches through `_captured`, which notes the launch and runs it inside a
# profiler span `mx_kernel:<index>`, so the kernels it starts are read as
# that launch's. Without an inspection a launch costs one test of this
# flag: no span, no host read, no synchronisation.
_CAPTURE = None


def _captured(fn, name, **shape):
    """`fn` (a library entry point), noting one launch of kernel `name` at
    `shape` (`inspect.roofline.kernel_cost`'s arguments, read after the
    profiled window) in the running inspection's capture."""
    idx = len(_CAPTURE)
    _CAPTURE.append((name, shape))

    def launch(*args):
        with torch.profiler.record_function(f"mx_kernel:{idx}"):
            return fn(*args)
    return launch


def reset_launch_counts():
    g = globals()
    with _COUNT_LOCK:
        for name in _COUNTERS:
            g[name + "_launches"] = 0
        _BY_DTYPE.clear()


def launch_counts_by_dtype():
    """{(counter name, dtype name): launches} since the last reset: the
    launches of `launch_counts()` by the type of the data they took
    ("scale_shift_act", "float16"; the flash kernels' tensor-core
    counters too, "flash_bwd_dq_wgmma") — the paged kernel's by its q
    ("paged_attention_q") and its slab ("paged_attention_kv")."""
    with _COUNT_LOCK:
        return dict(_BY_DTYPE)


def launch_counts():
    g = globals()
    with _COUNT_LOCK:
        return {name: g[name + "_launches"] for name in _COUNTERS}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from ops/csrc at first use")


_INCLUDE = re.compile(rb'^#include "([^"]+\.cuh)"', re.M)


@functools.lru_cache(maxsize=None)
def _flags():
    """`_NVCC_FLAGS`, plus `--split-compile 0` (the compiler's optimization
    passes over the source's many template instances spread over every
    core: the paged-attention source builds in about a third of the time)
    where this `nvcc` has the option."""
    flags = list(_NVCC_FLAGS)
    try:
        usage = subprocess.run([_nvcc(), "--help"], capture_output=True,
                               text=True, timeout=60).stdout
    except MXNetError:
        usage = ""
    if "--split-compile" in usage:
        flags += ["--split-compile", "0"]
    return tuple(flags)


def _lib_path(name):
    """(source, library path): the library's name hashes the source, every
    `csrc/*.cuh` header it includes (and theirs), and the flags."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(_flags()).encode())
    todo, seen = [src], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        digest.update(os.path.basename(path).encode() + b"\0" + text)
        todo += [os.path.join(_CSRC, h.decode())
                 for h in _INCLUDE.findall(text)]
    return src, os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=_SOURCES):
    """Compile every named source that has no current library, one `nvcc`
    process per source, all started together. Returns {name: seconds} of
    the sources compiled now (an up-to-date library costs nothing)."""
    todo = []
    for name in names:
        src, lib = _lib_path(name)
        if not os.path.isfile(lib):
            todo.append((name, src, lib))
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        p = subprocess.Popen([nvcc, *_flags(), "-o", tmp, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((name, lib, tmp, p))
    took, failed = {}, []
    for name, lib, tmp, p in procs:
        log, _ = p.communicate()
        with _BUILD_LOG_LOCK:
            BUILD_LOG[name] = log
        took[name] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def _load(name):
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_lib_path(name)[1])
            if name == "paged_attention":
                lib.mx_paged_attention_fwd.restype = ctypes.c_int
                lib.mx_paged_attention_fwd.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            elif name == "scale_shift_act":
                lib.mx_scale_shift_act.restype = ctypes.c_int
                lib.mx_scale_shift_act.argtypes = (
                    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
            elif name == "avg_pool2d":
                lib.mx_avg_pool2d_fwd.restype = ctypes.c_int
                lib.mx_avg_pool2d_fwd.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
                lib.mx_avg_pool2d_bwd.restype = ctypes.c_int
                lib.mx_avg_pool2d_bwd.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
            elif name == "flash_attention":
                tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
                lib.mx_flash_fwd.restype = ctypes.c_int
                lib.mx_flash_fwd.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + tail)
                lib.mx_flash_fwd_wgmma.restype = ctypes.c_int
                lib.mx_flash_fwd_wgmma.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + tail)
                lib.mx_flash_bwd_dq.restype = ctypes.c_int
                lib.mx_flash_bwd_dq.argtypes = (
                    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + tail)
                lib.mx_flash_bwd_dkv.restype = ctypes.c_int
                lib.mx_flash_bwd_dkv.argtypes = (
                    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + tail)
                lib.mx_flash_bwd_dq_wgmma.restype = ctypes.c_int
                lib.mx_flash_bwd_dq_wgmma.argtypes = (
                    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + tail)
                lib.mx_flash_bwd_dkv_wgmma.restype = ctypes.c_int
                lib.mx_flash_bwd_dkv_wgmma.argtypes = (
                    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + tail)
            elif name == "image_augment":
                lib.mx_image_augment.restype = ctypes.c_int
                lib.mx_image_augment.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p, ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 2)
            elif name == "nms":
                lib.mx_nms_sweep.restype = ctypes.c_int
                lib.mx_nms_sweep.argtypes = (
                    [ctypes.c_int] + [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
                lib.mx_proposal_sweep.restype = ctypes.c_int
                lib.mx_proposal_sweep.argtypes = (
                    [ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
                lib.mx_nms_mask_grid.restype = ctypes.c_int
                lib.mx_nms_mask_grid.argtypes = (
                    [ctypes.c_int] * 5 + [ctypes.c_void_p])
            elif name == "rnn_cell":
                lib.mx_rnn_cell_fwd.restype = ctypes.c_int
                lib.mx_rnn_cell_fwd.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
                lib.mx_rnn_cell_bwd.restype = ctypes.c_int
                lib.mx_rnn_cell_bwd.argtypes = (
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
            elif name == "rnn_layer":
                lib.mx_rnn_layer_fwd.restype = ctypes.c_int
                lib.mx_rnn_layer_fwd.argtypes = (
                    [ctypes.c_int] * 6 + [ctypes.c_void_p] * 10
                    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
                lib.mx_rnn_layer_bwd.restype = ctypes.c_int
                lib.mx_rnn_layer_bwd.argtypes = (
                    [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13
                    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
                lib.mx_rnn_layer_smem.restype = ctypes.c_longlong
                lib.mx_rnn_layer_smem.argtypes = (
                    [ctypes.c_int] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 2)
            lib.mx_cuda_error_string.restype = ctypes.c_char_p
            lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


# act name -> the kernels' activation code (csrc/scale_shift_act.cu)
ACT_CODES = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3, "silu": 4,
             "gelu": 5}
# the one table of dtype codes every wrapper passes and every C entry point
# of csrc/ reads; int8 is the paged kernel's quantized slab and an augment
# input, uint8, bool, int16 and int32 the augment kernel's other inputs
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3, torch.uint8: 4, torch.bool: 5, torch.int16: 6,
               torch.int32: 7}
# the float types every kernel takes (x, q, dO, the pooled tensor)
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
# the 16-bit types the tensor-core kernels (paged wgmma, flash) take
_TC_TYPES = (torch.bfloat16, torch.float16)

# Every shape rule the wrappers enforce, one row each: (kernel, kind, test,
# message). Kind "jax": the JAX package refuses the shape too; no other kind
# exists. Any other shape reaches a kernel: head dims 1..256 through
# capacity instances (32, 64, 128, 256) that mask the tail and any d past
# 256 through 128-column slices of the capacity-128 instance, any channel
# count through a scalar path beside the 16-byte vector one, any bh along a
# 1-D grid.
RULES = (
    ("scale_shift_act", "jax",
     lambda s: s["act"] not in ACT_CODES,
     "unsupported fused activation {act!r}"),
    ("avg_pool2d", "jax",
     lambda s: s["ph"] <= 0 or s["pw"] <= 0 or s["h"] % s["ph"]
     or s["w"] % s["pw"],
     "pool {ph}x{pw} must divide the spatial dims {h}x{w}"),
    ("image_augment", "jax",
     lambda s: not (0 < s["ch"] <= s["h"] and 0 < s["cw"] <= s["w"]),
     "crop {ch}x{cw} does not fit the images {h}x{w}"),
    ("image_augment", "jax",
     lambda s: _cuts(s) and s.get("c", 3) < 3,
     "a crop that cuts reads the first 3 channels; the images have {c}"),
    ("image_augment", "jax",
     lambda s: augment_channels(s.get("c", 3), _cuts(s), s.get("lm"),
                                s.get("ls")) is None,
     "mean and std of lengths {lm} and {ls} (None: not given) do not "
     "broadcast with the channels read (all {c}, or 3 under a crop that "
     "cuts)"),
)


def _cuts(s):
    return (s["ch"], s["cw"]) != (s["h"], s["w"])


def augment_channels(c, cuts, lm=None, ls=None):
    """(channels read, output channels) of the augment: all `c`, or the
    first 3 under a crop that `cuts` (lax.dynamic_slice's (ch, cw, 3)
    window), broadcast as numpy broadcasts with mean and std of lengths
    `lm` / `ls` (None: not given); None where they do not broadcast."""
    cr = 3 if cuts else c
    cout = cr
    for n in (lm, ls):
        if n is None or n == 1:
            continue
        if cout != 1 and n != cout:
            return None
        cout = n
    return cr, cout


def refusal(kernel, **shape):
    """Why the CUDA kernel `kernel` refuses `shape`, or None when a kernel
    takes it. Kernels and the shape keys their rules read:
    "paged_attention" (head_dim), "scale_shift_act" (act), "avg_pool2d"
    (h, w, ph, pw), "flash" (d; all four flash kernels), "image_augment"
    (h, w, ch, cw, and c channels, mean / std lengths lm / ls or None,
    which default to 3, None, None); the paged, flash and recurrent cell
    kernels have no row (the cell takes every float type, N and H; the
    recurrent layer's kernels take what `rnn_layer_route` sends them). Runs
    anywhere: the CPU tests hold it against the JAX package."""
    for name, _kind, test, message in RULES:
        if name == kernel and test(shape):
            return message.format(**shape)
    return None


def _refuse(name, kernel, **shape):
    why = refusal(kernel, **shape)
    if why is not None:
        raise MXNetError(f"{name}: {why}")


_PA_KV_DTYPES = _FLOATS + (torch.int8,)
_PA_ROUTES = {"split": 0, "wgmma": 1, "cuda_cores": 2}
# the split route's fixed pieces of the token axis (positions from 0), and
# the output columns a block takes past head dim 256
# (csrc/paged_attention.cu: kPiece, kSliceCols)
PAGED_PIECE = 256
PAGED_SLICE = 128
# the most query rows the split route takes (csrc: kSplitRows)
PAGED_SPLIT_ROWS = 16


def paged_route(q_dtype, kv_dtype, d, C):
    """Which kernel of `csrc/paged_attention.cu` takes (q dtype, slab dtype,
    head dim d, query rows C), from those four values alone:
    "split" for C <= 16 (decode, the speculative verify, short windows; a
    memory-bound read on the CUDA cores, split over fixed 256-position
    pieces and combined); "wgmma", the tensor cores, for longer chunks of
    16-bit q (bfloat16 or float16) over a slab of the same type at
    d % 8 == 0 or an int8 one at d % 16 == 0 (a row of whole 16-byte
    vectors), d <= 128 (a 64 x d f32 accumulator is d / 2 registers a
    thread); "cuda_cores" for every other chunk (float32 q or slab, which
    the tensor cores would take as TF32; a float16 side beside a bfloat16
    one, which no one wgmma takes; d off that alignment, d > 128)."""
    if C <= PAGED_SPLIT_ROWS:
        return "split"
    if (q_dtype in _TC_TYPES and d <= 128
            and ((kv_dtype == q_dtype and d % 8 == 0)
                 or (kv_dtype == torch.int8 and d % 16 == 0))):
        return "wgmma"
    return "cuda_cores"


def paged_attention_cuda(q, k_slab, v_slab, lengths, layer, k_scale=None,
                         v_scale=None):
    """Launch the paged-attention kernel (`csrc/paged_attention.cu`) that
    `paged_route(q.dtype, k_slab.dtype, D, C)` names.

    `q`: contiguous (S, C, H, D) CUDA tensor, float32, bfloat16 or float16.
    `k_slab`/`v_slab`: (rows, L, T, H, D) with rows > S, float32, bfloat16,
    float16 or int8 (any of them with any q dtype), one dtype, shape and
    strides, heads and dims contiguous; a view that cuts the position axis
    (`slab[:, :, :extent]`) is read in place, not copied. Any head_dim D:
    16-byte vector loads where every row is a whole number of aligned
    16-byte vectors, scalar loads otherwise; the "wgmma" route needs its
    buffers, slab strides and rows 16-byte aligned and raises naming the
    one that is not. int8 slabs need `k_scale`/`v_scale`: (rows, L, T)
    float32 with one set of strides, positions contiguous (the same view
    cut is read in place); float slabs take none.
    `lengths`: (S,) int32, each >= 0. Returns (S, C, H, D) in q's dtype.
    Counts one launch per call: over an int8 slab in
    `paged_attention_int8_launches`, any other in
    `paged_attention_launches`, and in the route's counter
    (`paged_attention_split_launches`, `paged_attention_wgmma_launches`,
    `paged_attention_cuda_cores_launches`). Raises `MXNetError` on any
    input the kernel does not take."""
    name = "paged_attention_cuda"
    quant = k_slab.dtype == torch.int8
    scales = [t for t in (k_scale, v_scale) if t is not None]
    if len(scales) != (2 if quant else 0):
        raise MXNetError(
            f"{name}: int8 slabs need k_scale and v_scale, float slabs "
            f"take none; got a {k_slab.dtype} slab and {len(scales)} "
            f"scale tensor(s)")
    tensors = (q, k_slab, v_slab, lengths) + tuple(scales)
    if not all(t.is_cuda for t in tensors):
        raise MXNetError(f"{name} takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise MXNetError(f"{name}: tensors on several devices")
    if q.dim() != 4 or k_slab.dim() != 5:
        raise MXNetError(
            f"{name}: q must be (S, C, H, D) and the slabs "
            f"(rows, L, T, H, D); got {tuple(q.shape)}, "
            f"{tuple(k_slab.shape)}")
    S, C, H, D = q.shape
    rows, L, T, Hk, Dk = k_slab.shape
    if q.dtype not in _FLOATS:
        raise MXNetError(f"{name}: q dtype {q.dtype} not taken "
                         f"(float32, bfloat16, float16)")
    if k_slab.dtype not in _PA_KV_DTYPES or v_slab.dtype != k_slab.dtype:
        raise MXNetError(f"{name}: slab dtypes {k_slab.dtype}, "
                         f"{v_slab.dtype} not taken (one of float32, "
                         f"bfloat16, float16, int8)")
    _refuse(name, "paged_attention", head_dim=D)
    if (Hk, Dk) != (H, D) or rows <= S or not 0 <= layer < L:
        raise MXNetError(
            f"{name}: slab {tuple(k_slab.shape)} does not serve q "
            f"{tuple(q.shape)} at layer {layer}")
    if v_slab.shape != k_slab.shape or v_slab.stride() != k_slab.stride():
        raise MXNetError(f"{name}: k and v slabs differ in shape or "
                         f"strides")
    st = k_slab.stride()
    if st[4] != 1 or st[3] != D:
        raise MXNetError(f"{name}: slab strides {st} not taken (heads and "
                         f"dims contiguous)")
    if quant:
        for t in scales:
            if (t.dtype != torch.float32 or t.shape != (rows, L, T)
                    or t.stride() != k_scale.stride() or t.stride(2) != 1):
                raise MXNetError(
                    f"{name}: k_scale and v_scale must be ({rows}, {L}, "
                    f"{T}) float32 with one set of strides, positions "
                    f"contiguous; got {tuple(t.shape)} {t.dtype} strides "
                    f"{t.stride()}")
    if not q.is_contiguous():
        raise MXNetError(f"{name}: q must be contiguous")
    if (lengths.dtype != torch.int32 or lengths.shape != (S,)
            or not lengths.is_contiguous()):
        raise MXNetError(f"{name}: lengths must be a contiguous (S,) int32 "
                         f"tensor")
    route = paged_route(q.dtype, k_slab.dtype, D, C)
    kl, vl = k_slab[:, layer], v_slab[:, layer]
    ksl = k_scale[:, layer] if quant else None
    vsl = v_scale[:, layer] if quant else None
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if route == "wgmma":
        _check_aligned(name, q=q, out=out, k_slab=kl, v_slab=vl)
        item = k_slab.element_size()
        bad = [f"{n} {s}" for n, s in (("row stride", st[0]),
                                       ("position stride", st[2]))
               if s * item % 16]
        if bad:
            raise MXNetError(f"{name}: slab {', '.join(bad)} (elements) not "
                             f"a whole number of 16-byte vectors, which the "
                             f"tensor-core route's tile loads need")
    lib = _load("paged_attention")
    # the split route's partials: (S, H, pieces, C, D) accumulators, then
    # (S, H, pieces, C, 2) maxima and normalisers, f32
    ws = None
    if route == "split":
        pieces = -(-T // PAGED_PIECE)
        ws = torch.empty(S * H * pieces * C * (D + 2), dtype=torch.float32,
                         device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch = lib.mx_paged_attention_fwd if _CAPTURE is None else _captured(
        lib.mx_paged_attention_fwd,
        "paged_attention_int8" if quant else "paged_attention",
        lengths=lengths, C=C, T=T, H=H, D=D,
        dtype=q.dtype, kv_dtype=k_slab.dtype)
    rc = launch(
        _PA_ROUTES[route], DTYPE_CODES[q.dtype], DTYPE_CODES[k_slab.dtype],
        q.device.index or 0, q.data_ptr(), kl.data_ptr(), vl.data_ptr(),
        ksl.data_ptr() if quant else None, vsl.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, S, C, H, D, T, st[0],
        st[2], k_scale.stride(0) if quant else 0, PAGED_PIECE, PAGED_SLICE,
        stream)
    if rc != 0:
        raise _launch_failed(lib, "paged_attention", rc)
    _count_launch("paged_attention_int8" if quant else "paged_attention",
                  f"paged_attention_{route}")
    _count_dtype("paged_attention_q", q.dtype)
    _count_dtype("paged_attention_kv", k_slab.dtype)
    return out


def _launch_failed(lib, name, rc):
    return MXNetError(f"{name} kernel launch failed: CUDA error {rc} "
                      f"({lib.mx_cuda_error_string(rc).decode()})")


def _check_cuda(name, tensors):
    if not all(t.is_cuda for t in tensors):
        raise MXNetError(f"{name} takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise MXNetError(f"{name}: tensors on several devices")


def _check_aligned(name, **tensors):
    bad = [n for n, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise MXNetError(f"{name}: {', '.join(bad)} not 16-byte aligned")


def scale_shift_act_cuda(x2d, scale, shift, residual, act_type):
    """Launch the fused apply kernel (`csrc/scale_shift_act.cu`):
    act(x2d * scale + shift + residual) over a row-major (M, C) view, f32
    inside, returned in x2d's dtype.

    `x2d`: contiguous (M, C), float32, bfloat16 or float16, any C (16-byte vectors
    when C * itemsize is a multiple of 16 and every buffer is 16-byte
    aligned, one element a thread otherwise). `scale`/`shift`: contiguous
    (C,) float32, or None. `residual`:
    None or contiguous (M, C) of x2d's dtype. `act_type`: a key of
    `ACT_CODES`. Raises `MXNetError` on any input the kernel does not take
    (a strided view included: the caller copies, and counts the copy)."""
    name = "scale_shift_act_cuda"
    rows = [t for t in (scale, shift) if t is not None]
    full = [x2d] + ([residual] if residual is not None else [])
    _check_cuda(name, full + rows)
    _refuse(name, "scale_shift_act", act=act_type)
    if x2d.dim() != 2 or x2d.dtype not in _FLOATS:
        raise MXNetError(f"{name}: x must be a 2-D float32, bfloat16 or "
                         f"float16 tensor; got {tuple(x2d.shape)} {x2d.dtype}")
    M, C = x2d.shape
    if residual is not None and (residual.shape != x2d.shape
                                 or residual.dtype != x2d.dtype):
        raise MXNetError(f"{name}: residual must match x in shape and dtype")
    for t in rows:
        if t.shape != (C,) or t.dtype != torch.float32:
            raise MXNetError(f"{name}: scale and shift must be ({C},) "
                             f"float32; got {tuple(t.shape)} {t.dtype}")
    if not all(t.is_contiguous() for t in full + rows):
        raise MXNetError(f"{name}: x, residual, scale and shift must be "
                         f"contiguous")
    out = torch.empty_like(x2d)
    if out.numel() == 0:
        return out
    lib = _load("scale_shift_act")
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    launch = lib.mx_scale_shift_act if _CAPTURE is None else _captured(
        lib.mx_scale_shift_act, "scale_shift_act", M=M, C=C,
        dtype=x2d.dtype, act=act_type, residual=residual is not None,
        scale=scale is not None, shift=shift is not None)
    rc = launch(
        DTYPE_CODES[x2d.dtype], ACT_CODES[act_type], x2d.device.index or 0,
        x2d.data_ptr(), scale.data_ptr() if scale is not None else None,
        shift.data_ptr() if shift is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), M, C, stream)
    if rc != 0:
        raise _launch_failed(lib, "scale_shift_act", rc)
    _count_launch("scale_shift_act")
    _count_dtype("scale_shift_act", x2d.dtype)
    return out


_POOL_ROUTES = {"window": 0, "per_output": 1}
# the most window positions the per-output route takes
# (csrc/avg_pool2d.cu: a thread issues them four loads at a time)
POOL_PER_OUTPUT_MAX = 16


def pool_route(ph, pw, c, dtype, aligned):
    """(route, vector) of both pooling passes of `csrc/avg_pool2d.cu` for a
    (ph, pw) window over c channels of `dtype`, from those values alone:
    "window" for windows of more than 16 positions (the global pool: a
    window split over 16 threads a word, summed in a fixed order, so
    enough loads are in flight although the output has few pixels),
    "per_output" for the rest (one thread an output word; the pixels fill
    the card). The vector is the channels of one 16-byte word a
    thread (8 in bfloat16 and float16, 4 in float32) where c is a multiple
    of it and both buffers are 16-byte `aligned`, else 1. The spatial dims
    and the batch do not enter."""
    route = "window" if ph * pw > POOL_PER_OUTPUT_MAX else "per_output"
    word = 16 // torch.empty((), dtype=dtype).element_size()
    return route, word if c % word == 0 and aligned else 1


def _pool_check(name, t, ph, pw, spatial=None):
    """Checks of an NHWC pooling operand; `spatial` is the (h, w) pooled
    over (the forward's own, or the backward's dX)."""
    _check_cuda(name, (t,))
    if t.dim() != 4 or t.dtype not in _FLOATS:
        raise MXNetError(f"{name}: takes a 4-D NHWC float32, bfloat16 or "
                         f"float16 tensor; got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise MXNetError(f"{name}: the NHWC tensor must be contiguous")
    h, w = t.shape[1:3] if spatial is None else spatial
    _refuse(name, "avg_pool2d", h=h, w=w, ph=ph, pw=pw)


def _pool_args(src, dst, c, ph, pw):
    """(dtype code, route code, vector) of a pooling launch."""
    route, vec = pool_route(ph, pw, c, src.dtype, src.data_ptr() % 16 == 0
                            and dst.data_ptr() % 16 == 0)
    return DTYPE_CODES[src.dtype], _POOL_ROUTES[route], vec


def avg_pool2d_fwd_cuda(x, ph, pw):
    """Launch the pooling forward (`csrc/avg_pool2d.cu`): the mean over
    each non-overlapping (ph, pw) window of a contiguous NHWC float32,
    bfloat16 or float16 tensor, f32 inside, in x's dtype, on the route
    `pool_route` names. Any channel count."""
    name = "avg_pool2d_fwd_cuda"
    _pool_check(name, x, ph, pw)
    n, h, w, c = x.shape
    y = x.new_empty((n, h // ph, w // pw, c))
    if y.numel() == 0:
        return y
    lib = _load("avg_pool2d")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = lib.mx_avg_pool2d_fwd if _CAPTURE is None else _captured(
        lib.mx_avg_pool2d_fwd, "avg_pool2d_fwd", N=n, H=h, W=w, C=c,
        ph=ph, pw=pw, dtype=x.dtype)
    rc = launch(*_pool_args(x, y, c, ph, pw), x.device.index or 0,
                x.data_ptr(), y.data_ptr(), n, h, w, c, ph, pw, stream)
    if rc != 0:
        raise _launch_failed(lib, "avg_pool2d_fwd", rc)
    _count_launch("avg_pool2d_fwd")
    _count_dtype("avg_pool2d_fwd", x.dtype)
    return y


def avg_pool2d_bwd_cuda(dy, h, w, ph, pw):
    """Launch the pooling backward (`csrc/avg_pool2d.cu`): dX (N, h, w, C)
    from a contiguous NHWC dY (N, h/ph, w/pw, C), each dY value times
    1/(ph*pw) broadcast over its window, in dy's dtype; the forward's
    types, routes and channel counts."""
    name = "avg_pool2d_bwd_cuda"
    _pool_check(name, dy, ph, pw, (h, w))
    n, ho, wo, c = dy.shape
    if (ho * ph, wo * pw) != (h, w):
        raise MXNetError(f"{name}: dy {tuple(dy.shape)} is not the pool "
                         f"{ph}x{pw} of {h}x{w}")
    dx = dy.new_empty((n, h, w, c))
    if dx.numel() == 0:
        return dx
    lib = _load("avg_pool2d")
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    inv = float(torch.tensor(1.0 / (ph * pw), dtype=torch.float32))
    launch = lib.mx_avg_pool2d_bwd if _CAPTURE is None else _captured(
        lib.mx_avg_pool2d_bwd, "avg_pool2d_bwd", N=n, H=h, W=w, C=c,
        ph=ph, pw=pw, dtype=dy.dtype)
    rc = launch(*_pool_args(dy, dx, c, ph, pw), dy.device.index or 0,
                dy.data_ptr(), dx.data_ptr(), n, h, w, c, ph, pw, inv,
                stream)
    if rc != 0:
        raise _launch_failed(lib, "avg_pool2d_bwd", rc)
    _count_launch("avg_pool2d_bwd")
    _count_dtype("avg_pool2d_bwd", dy.dtype)
    return dx


def flash_fwd_route(dtype, d):
    """Which forward kernel (B5, B6) takes (dtype, head dim d): "wgmma",
    the tensor-core kernel, for bfloat16 and float16 at d a multiple of 8
    (a TMA tensor map needs rows of whole 16-byte vectors) up to 128, else
    "cuda_cores". The kernel is one template over the 16-bit type (its
    maps, wgmma operand type, split of P and stores). float32 stays off
    the tensor cores, which would take it as TF32; d over 128 (over 256 in
    128-column slices) because a 64 x d f32 accumulator (O here, dK and dV
    in the backward) is d / 2 registers a thread, which at d = 256 leaves
    no room for the scores and the rest."""
    return "wgmma" if dtype in _TC_TYPES and d % 8 == 0 and d <= 128 \
        else "cuda_cores"


def flash_bwd_route(dtype, d):
    """Which backward kernels (B7 dq sweep, B8 dk/dv sweep) take (dtype,
    head dim d): the forward's route, "wgmma" for bfloat16 and float16 at
    d a multiple of 8 up to 128, else "cuda_cores". The tensor-core sweeps
    are templates over the 16-bit type; float16's shift P by 2^15 and
    scale dS by a power of two per output row before splitting them into
    two float16 terms, so neither falls into float16's subnormals
    (`attention.flash_bwd_split_ref` emulates it)."""
    return flash_fwd_route(dtype, d)


def _flash_check(name, q, k, v, extra=()):
    """Checks shared by the flash wrappers: q (bh, tq, d), k and v
    (bh, tk, d), one dtype (float32, bfloat16 or float16), d the `refusal` table
    takes (any), every tensor contiguous and on one card. `extra` are
    further operands of q's shape and dtype (dO). Returns (bh, tq, tk,
    d)."""
    _check_cuda(name, (q, k, v) + tuple(extra))
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise MXNetError(f"{name}: q, k, v must be (bh, T, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise MXNetError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not serve q {tuple(q.shape)}")
    if q.dtype not in _FLOATS or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(f"{name}: q, k, v must share one dtype, float32, "
                         f"bfloat16 or float16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    _refuse(name, "flash", d=d)
    for t in extra:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise MXNetError(f"{name}: dO must match q in shape and dtype")
    if not all(t.is_contiguous() for t in (q, k, v) + tuple(extra)):
        raise MXNetError(f"{name}: q, k, v and dO must be contiguous")
    return bh, tq, k.shape[1], d


def _row_stat(name, t, bh, tq, what):
    if (t.dtype != torch.float32 or t.shape != (bh, tq, 1)
            or not t.is_contiguous()):
        raise MXNetError(f"{name}: {what} must be a contiguous ({bh}, {tq}, "
                         f"1) float32 tensor; got {tuple(t.shape)} {t.dtype}")


def flash_fwd_cuda(q, k, v, causal, scale, with_lse):
    """Launch the flash-attention forward (`csrc/flash_attention.cu`):
    softmax(q k^T * scale, end-aligned causal mask when `causal`) v over
    (bh, T, d), f32 inside, in q's dtype; a row with no live key gives 0.
    With `with_lse` also the per-row log-sum-exp, (bh, tq, 1) float32,
    -1e30 on rows with no live key. Returns o, or (o, lse). The kernel is
    `flash_fwd_route(q.dtype, d)`'s: the tensor-core one (its buffers
    16-byte aligned) or the CUDA-core one; a tensor-core launch also counts
    in `flash_fwd_wgmma_launches` / `flash_fwd_lse_wgmma_launches`. Raises
    `MXNetError` on any input the kernel does not take."""
    name = "flash_fwd_cuda"
    bh, tq, tk, d = _flash_check(name, q, k, v)
    o = torch.empty_like(q)
    lse = q.new_empty((bh, tq, 1), dtype=torch.float32) if with_lse else None
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    lib = _load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None)
    tail = (bh, tq, tk, int(causal), float(scale), stream)
    tensor_cores = flash_fwd_route(q.dtype, d) == "wgmma"
    if tensor_cores:
        _check_aligned(name, q=q, k=k, v=v, o=o)
    launch = lib.mx_flash_fwd_wgmma if tensor_cores else lib.mx_flash_fwd
    if _CAPTURE is not None:
        launch = _captured(launch, "flash_fwd_lse" if with_lse
                           else "flash_fwd", bh=bh, tq=tq, tk=tk, d=d,
                           causal=bool(causal), dtype=q.dtype)
    rc = launch(DTYPE_CODES[q.dtype], q.device.index or 0, d, int(with_lse),
                *ptrs, *tail)
    if rc != 0:
        raise _launch_failed(lib, "flash_fwd", rc)
    if with_lse:
        _count_launch("flash_fwd_lse")
        _count_dtype("flash_fwd_lse", q.dtype)
        if tensor_cores:
            _count_launch("flash_fwd_lse_wgmma")
            _count_dtype("flash_fwd_lse_wgmma", q.dtype)
        return o, lse
    _count_launch("flash_fwd")
    _count_dtype("flash_fwd", q.dtype)
    if tensor_cores:
        _count_launch("flash_fwd_wgmma")
        _count_dtype("flash_fwd_wgmma", q.dtype)
    return o


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the flash backward's dq sweep (`csrc/flash_attention.cu`):
    dq = scale * sum_k p * (dO v^T - delta) k with p = exp(s - lse), zero
    on masked keys and on rows whose lse is the -1e30 sentinel. `lse` and
    `delta` (rowsum(dO * o)) are (bh, tq, 1) float32. Returns dq in q's
    dtype. The kernel is `flash_bwd_route(q.dtype, d)`'s: the tensor-core
    one (its buffers 16-byte aligned; the launch also counts in
    `flash_bwd_dq_wgmma_launches`) or the CUDA-core one."""
    name = "flash_bwd_dq_cuda"
    _check_cuda(name, (lse, delta))
    bh, tq, tk, d = _flash_check(name, q, k, v, (do,))
    _row_stat(name, lse, bh, tq, "lse")
    _row_stat(name, delta, bh, tq, "delta")
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    lib = _load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    tail = (bh, tq, tk, int(causal), float(scale), stream)
    tensor_cores = flash_bwd_route(q.dtype, d) == "wgmma"
    if tensor_cores:
        _check_aligned(name, q=q, k=k, v=v, do=do, dq=dq)
    launch = (lib.mx_flash_bwd_dq_wgmma if tensor_cores
              else lib.mx_flash_bwd_dq)
    if _CAPTURE is not None:
        launch = _captured(launch, "flash_bwd_dq", bh=bh, tq=tq, tk=tk, d=d,
                           causal=bool(causal), dtype=q.dtype)
    rc = launch(DTYPE_CODES[q.dtype], q.device.index or 0, d, *ptrs, *tail)
    if rc != 0:
        raise _launch_failed(lib, "flash_bwd_dq", rc)
    _count_launch("flash_bwd_dq")
    _count_dtype("flash_bwd_dq", q.dtype)
    if tensor_cores:
        _count_launch("flash_bwd_dq_wgmma")
        _count_dtype("flash_bwd_dq_wgmma", q.dtype)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the flash backward's dk/dv sweep (`csrc/flash_attention.cu`):
    dv = sum_q p^T dO and dk = scale * sum_q ds^T q, with the dq sweep's p,
    ds, sentinel and mask rules. Returns (dk, dv) in k's dtype, from the
    kernel `flash_bwd_route(q.dtype, d)` names (a tensor-core launch also
    counts in `flash_bwd_dkv_wgmma_launches`)."""
    name = "flash_bwd_dkv_cuda"
    _check_cuda(name, (lse, delta))
    bh, tq, tk, d = _flash_check(name, q, k, v, (do,))
    _row_stat(name, lse, bh, tq, "lse")
    _row_stat(name, delta, bh, tq, "delta")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lib = _load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (bh, tq, tk, int(causal), float(scale), stream)
    tensor_cores = flash_bwd_route(q.dtype, d) == "wgmma"
    if tensor_cores:
        _check_aligned(name, q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    launch = (lib.mx_flash_bwd_dkv_wgmma if tensor_cores
              else lib.mx_flash_bwd_dkv)
    if _CAPTURE is not None:
        launch = _captured(launch, "flash_bwd_dkv", bh=bh, tq=tq, tk=tk,
                           d=d, causal=bool(causal), dtype=q.dtype)
    rc = launch(DTYPE_CODES[q.dtype], q.device.index or 0, d, *ptrs, *tail)
    if rc != 0:
        raise _launch_failed(lib, "flash_bwd_dkv", rc)
    _count_launch("flash_bwd_dkv")
    _count_dtype("flash_bwd_dkv", q.dtype)
    if tensor_cores:
        _count_launch("flash_bwd_dkv_wgmma")
        _count_dtype("flash_bwd_dkv_wgmma", q.dtype)
    return dk, dv


# The most bytes of suppression mask one launch of the NMS kernels takes:
# images beyond it go in further launches of the same call. 512 MiB holds
# SSD300's (32, 8732) in one (307 MB); a single image over it still runs,
# alone.
NMS_MASK_CAP_BYTES = 1 << 29


def nms_mask_bytes(images, A):
    """Bytes of the suppression mask the NMS kernels write for `images`
    images of A rows: a 64-bit word for each row and each 64 rows."""
    return images * (-(-A // 64)) * A * 8


def _sweep_checked(name, boxes, ids, keep):
    """The checks both sweeps' wrappers make; raises `MXNetError`."""
    tensors = [boxes, keep] + ([ids] if ids is not None else [])
    _check_cuda(name, tensors)
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or boxes.dtype != torch.float32:
        raise MXNetError(f"{name}: boxes must be (B, A, 4) float32; got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    B, A = boxes.shape[:2]
    if keep.shape != (B, A) or keep.dtype != torch.bool:
        raise MXNetError(f"{name}: keep must be ({B}, {A}) bool; got "
                         f"{tuple(keep.shape)} {keep.dtype}")
    if ids is not None and (ids.shape != (B, A)
                            or ids.dtype != torch.float32):
        raise MXNetError(f"{name}: ids must be ({B}, {A}) float32; got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f"{name}: boxes, ids and keep must be contiguous")
    _check_aligned(name, boxes=boxes)


def _sweep(kernel, boxes, ids, keep, thresh):
    """The keep mask after the two kernels of `csrc/nms.cu` (`kernel`:
    "nms_sweep", or "proposal_sweep" for the pixel-inclusive IoU, which
    takes no ids), the images in groups past `NMS_MASK_CAP_BYTES`, each
    group its own pair of launches over one workspace."""
    out = keep.clone()
    if out.numel() == 0:
        return out
    B, A = boxes.shape[:2]
    lib = _load("nms")
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    group = max(1, min(B, NMS_MASK_CAP_BYTES // nms_mask_bytes(1, A)))
    mask = torch.empty(nms_mask_bytes(group, A) // 8, dtype=torch.int64,
                       device=boxes.device)
    plus_one = kernel == "proposal_sweep"
    fn = lib.mx_proposal_sweep if plus_one else lib.mx_nms_sweep
    for b0 in range(0, B, group):
        b1 = min(B, b0 + group)
        launch = fn if _CAPTURE is None else _captured(
            fn, kernel, B=b1 - b0, A=A,
            **({} if plus_one else {"ids": ids is not None}))
        ptrs = (boxes[b0:b1].data_ptr(),)
        if not plus_one:
            ptrs += (ids[b0:b1].data_ptr() if ids is not None else None,)
        rc = launch(boxes.device.index or 0, *ptrs, out[b0:b1].data_ptr(),
                    mask.data_ptr(), b1 - b0, A, float(thresh), stream)
        if rc != 0:
            raise _launch_failed(lib, kernel, rc)
    return out


def nms_sweep_cuda(boxes, ids, keep, thresh):
    """Launch the greedy NMS sweep (`csrc/nms.cu`): the keep mask after
    sweeping rows already in score order, as `ops.contrib.nms_sweep_ref`
    computes it, bit for bit.

    `boxes`: contiguous (B, A, 4) float32 corner boxes; `ids`: contiguous
    (B, A) float32 class ids, or None (one class); `keep`: (B, A) bool, the
    rows alive at the start (not modified); `thresh`: the IoU above which a
    later row is suppressed, rounded to float32 as PyTorch's comparison
    rounds it. Returns a new (B, A) bool mask. The kernels first write a
    suppression bitmask (`nms_mask_bytes`) into an int64 workspace
    allocated here, then sweep it; past `NMS_MASK_CAP_BYTES` the images go
    in groups, each its own pair of kernels over one workspace (each image
    is swept on its own, so the bits are the same). One call counts one
    launch. Raises `MXNetError` on any input the kernel does not take."""
    _sweep_checked("nms_sweep_cuda", boxes, ids, keep)
    out = _sweep("nms_sweep", boxes, ids, keep, thresh)
    if out.numel():
        _count_launch("nms_sweep")
        _count_dtype("nms_sweep", boxes.dtype)
    return out


def proposal_sweep_cuda(boxes, keep, thresh):
    """Launch the proposal op's greedy sweep (`csrc/nms.cu`, the
    pixel-inclusive instance of the NMS kernels): the keep mask after
    sweeping rows already in score order, as
    `ops.contrib.proposal_sweep_ref` computes it, bit for bit.

    `boxes`: contiguous (B, A, 4) float32 corner boxes; `keep`: (B, A)
    bool, the rows alive at the start (not modified); `thresh`: as
    `nms_sweep_cuda`'s. No class ids. Returns a new (B, A) bool mask; the
    workspace and the groups as `nms_sweep_cuda`'s. One call counts one
    launch in `proposal_sweep_launches`. Raises `MXNetError` on any input
    the kernel does not take."""
    _sweep_checked("proposal_sweep_cuda", boxes, None, keep)
    out = _sweep("proposal_sweep", boxes, None, keep, thresh)
    if out.numel():
        _count_launch("proposal_sweep")
        _count_dtype("proposal_sweep", boxes.dtype)
    return out


# the augment's input types (uint8, int8 and bool take the table route),
# the most output channels of its table, the most mean / std entries passed
# by value, the widest pixel (C * item bytes) its staged routes take
# (csrc/image_augment.cu: kTableChannels, kParamChannels, kStageBytes - 30)
_AUGMENT_IN = (torch.uint8, torch.int8, torch.bool, torch.int16, torch.int32,
               torch.float32)
_AUGMENT_BYTES = (torch.uint8, torch.int8, torch.bool)
AUGMENT_TABLE_CHANNELS = 4
AUGMENT_PARAM_CHANNELS = 64
AUGMENT_PIXEL_BYTES = 12258
_AUGMENT_ROUTES = {"table": 0, "direct": 1, "scalar": 2}


def augment_route(in_dtype, c, cout, cw):
    """Which path of `csrc/image_augment.cu` takes images of `in_dtype` with
    `c` channels into `cout` output channels at crop width `cw`: "scalar"
    (an element a thread, straight from device memory) for a pixel wider
    than AUGMENT_PIXEL_BYTES or a row of 2^31 elements or more; "table"
    (staged 16-byte copies, a shared lookup table of the 256 values of
    each output channel) for uint8, int8 and bool at cout <=
    AUGMENT_TABLE_CHANNELS; "direct" (the same staging, each element
    computed) otherwise. Any data_ptr: the staging copies the 16-byte
    chunks that cover a span, the tensor's first and last bytes one by
    one."""
    item = torch.empty(0, dtype=in_dtype).element_size()
    if c * item > AUGMENT_PIXEL_BYTES or cw * cout >= 2 ** 31:
        return "scalar"
    if in_dtype in _AUGMENT_BYTES and cout <= AUGMENT_TABLE_CHANNELS:
        return "table"
    return "direct"


def _device_floats(values, device):
    """float32 `values` on `device`, copied from page-locked memory on the
    current stream: the host does not wait for the card."""
    host = torch.tensor(values, dtype=torch.float32).pin_memory()
    return host.to(device, non_blocking=True)


def image_augment_cuda(images, y0, x0, flips, crop_hw, mean, std, out_dtype):
    """Launch the input path's augment kernel (`csrc/image_augment.cu`) on
    the route `augment_route` names: crop each image at (y0[n], x0[n]) to
    `crop_hw`, mirror it where flips[n], scale integer pixels by 1/255,
    subtract `mean`, divide by `std` and cast, in one pass, as
    `ops.fused.image_augment_ref` computes it, bit for bit.

    `images`: contiguous (N, H, W, C) uint8, int8, bool (read as 0 / 1),
    int16, int32 or float32. The channels read are all C, or the first 3
    under a crop that cuts; the output has their broadcast with the
    lengths of mean and std. `y0` / `x0`: contiguous (N,) int32, or None
    (no crop: `crop_hw` is (H, W)), each read as lax.dynamic_slice reads a
    start (negative from the end, then clamped so the crop fits). `flips`:
    contiguous (N,) bool or uint8, or None. `mean` / `std`: tuples of
    floats, or None. `out_dtype`: float32, bfloat16 or float16. Returns a
    new (N, ch, cw, cout) tensor. Counts one launch in
    `image_augment_launches` and one in the route's counter. Raises
    `MXNetError` on any input the kernel does not take."""
    name = "image_augment_cuda"
    draws = [t for t in (y0, x0, flips) if t is not None]
    _check_cuda(name, [images] + draws)
    if images.dim() != 4 or images.dtype not in _AUGMENT_IN:
        raise MXNetError(f"{name}: images must be (N, H, W, C) of "
                         f"{_AUGMENT_IN}; got {tuple(images.shape)} "
                         f"{images.dtype}")
    if out_dtype not in _FLOATS:
        raise MXNetError(f"{name}: out_dtype must be one of {_FLOATS}; got "
                         f"{out_dtype}")
    N, H, W, C = images.shape
    ch, cw = (int(v) for v in crop_hw)
    lm, ls = (None if v is None else len(v) for v in (mean, std))
    _refuse(name, "image_augment", h=H, w=W, ch=ch, cw=cw, c=C, lm=lm, ls=ls)
    cr, cout = augment_channels(C, (ch, cw) != (H, W), lm, ls)
    if (y0 is None) != (x0 is None) or (y0 is None and (ch, cw) != (H, W)):
        raise MXNetError(f"{name}: a crop smaller than the images needs "
                         f"both y0 and x0")
    for label, t, dts in (("y0", y0, (torch.int32,)),
                          ("x0", x0, (torch.int32,)),
                          ("flips", flips, (torch.bool, torch.uint8))):
        if t is not None and (t.shape != (N,) or t.dtype not in dts):
            raise MXNetError(f"{name}: {label} must be ({N},) of "
                             f"{dts}; got {tuple(t.shape)} {t.dtype}")
    if not all(t.is_contiguous() for t in [images] + draws):
        raise MXNetError(f"{name}: images and draws must be contiguous")
    shape = (N, ch, cw, cout)
    if N * ch * cw * cout == 0:
        return torch.empty(shape, dtype=out_dtype, device=images.device)
    route = augment_route(images.dtype, C, cout, cw)
    lib = _load("image_augment")
    out = torch.empty(shape, dtype=out_dtype, device=images.device)
    consts = [None if v is None else (ctypes.c_float * min(
        len(v), AUGMENT_PARAM_CHANNELS))(*map(float, v[:AUGMENT_PARAM_CHANNELS]))
        for v in (mean, std)]
    far = None
    if max(lm or 0, ls or 0) > AUGMENT_PARAM_CHANNELS:
        far = _device_floats(list(mean or ()) + list(std or ()),
                             images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    launch = lib.mx_image_augment if _CAPTURE is None else _captured(
        lib.mx_image_augment, "image_augment", N=N, ch=ch, cw=cw,
        in_dtype=images.dtype, out_dtype=out_dtype, cr=cr, cout=cout)
    rc = launch(
        DTYPE_CODES[images.dtype], DTYPE_CODES[out_dtype],
        _AUGMENT_ROUTES[route], images.device.index or 0, images.data_ptr(),
        images.numel() * images.element_size(), ptr(y0), ptr(x0),
        ptr(flips), out.data_ptr(), N, H, W, C, ch, cw, cr, cout, consts[0],
        lm or 0, consts[1], ls or 0, ptr(far), stream)
    if rc != 0:
        raise _launch_failed(lib, "image_augment", rc)
    _count_launch("image_augment", f"image_augment_{route}")
    _count_dtype("image_augment", out_dtype)
    return out


# ---------------------------------------------------------------------------
# the recurrent cell (csrc/rnn_cell.cu; the plain versions are
# ops/rnn.py :: cell_fwd_ref / cell_bwd_ref)
# ---------------------------------------------------------------------------
# the cell kernels' mode and activation codes (csrc/rnn_cell.cu: Mode,
# Act) and each mode's gate count
RNN_MODES = {"lstm": 0, "gru": 1, "rnn": 2}
RNN_GATES = {"lstm": 4, "gru": 3, "rnn": 1}
RNN_ACTS = {"tanh": 0, "relu": 1, "sigmoid": 2, "softrelu": 3,
            "softsign": 4, "log_sigmoid": 5}


def rnn_cell_vec(H, dtype, tensors=()):
    """Elements a thread of the cell kernels takes (one load of V x
    itemsize bytes from each gate block): the largest of 16 bytes' worth
    (4 float32, 8 bfloat16 or float16) and its halves down to 1 that
    divides H and to whose alignment every pointer in `tensors` keeps
    (csrc/rnn_cell.cu :: pick_vec)."""
    item = torch.empty(0, dtype=dtype).element_size()
    v = 16 // item
    while v > 1 and (H % v or any(t.data_ptr() % (v * item)
                                  for t in tensors if t is not None)):
        v //= 2
    return v


def _rnn_check(name, mode, act, named):
    """The dtype after checking every tensor of `named` ({label: (tensor
    or None, shape, required)}): on one card, of one float dtype, of its
    shape, contiguous."""
    if mode not in RNN_MODES or act not in RNN_ACTS:
        raise MXNetError(f"{name}: mode {mode!r} / activation {act!r} not "
                         f"one of {sorted(RNN_MODES)} / {sorted(RNN_ACTS)}")
    present = [t for t, _, _ in named.values() if t is not None]
    _check_cuda(name, present)
    dt = present[0].dtype
    if dt not in _FLOATS:
        raise MXNetError(f"{name}: float32, bfloat16 or float16 only; got "
                         f"{dt}")
    for label, (t, shape, required) in named.items():
        if t is None:
            if required:
                raise MXNetError(f"{name}: {mode} needs {label}")
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise MXNetError(f"{name}: {label} must be {tuple(shape)} {dt}; "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: {label} must be contiguous")
    return dt


def rnn_cell_fwd_cuda(mode, gx, gh, h, c, act="tanh", save=True):
    """Launch the recurrent cell's forward (`csrc/rnn_cell.cu`): from the
    gate pre-activations gx, gh (N, G H) and the previous state (h for
    the GRU, c for the LSTM; the other is not read) compute h' (and the
    LSTM's c') and, with `save`, the gate activations the backward reads
    (LSTM i, f, g, o; GRU r, z, n; nothing for the RNN), every value in
    float32 and rounded once to the inputs' dtype, as `ops.rnn.
    cell_fwd_ref` computes them. `mode` "lstm", "gru" or "rnn", `act` a
    key of `ops.rnn.ACTS`. Every tensor contiguous, of one float dtype, on
    one card. Returns (h', c' or None, activations or None); counts one launch
    in `rnn_cell_fwd_launches`. Raises `MXNetError` on any input the
    kernel does not take."""
    name = "rnn_cell_fwd_cuda"
    G = RNN_GATES.get(mode, 1)
    if gx.dim() != 2 or gx.shape[-1] % G:
        raise MXNetError(f"{name}: gx must be (N, {G} H); got "
                         f"{tuple(gx.shape)}")
    N, H = gx.shape[0], gx.shape[1] // G
    _rnn_check(name, mode, act, {
        "gx": (gx, (N, G * H), True), "gh": (gh, (N, G * H), True),
        "h": (h if mode == "gru" else None, (N, H), mode == "gru"),
        "c": (c if mode == "lstm" else None, (N, H), mode == "lstm")})
    code = RNN_MODES[mode]
    h_new = torch.empty((N, H), dtype=gx.dtype, device=gx.device)
    c_new = torch.empty_like(h_new) if mode == "lstm" else None
    saved = (torch.empty_like(gx) if save and mode != "rnn" else None)
    if N * H == 0:
        return h_new, c_new, saved
    lib = _load("rnn_cell")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    launch = lib.mx_rnn_cell_fwd if _CAPTURE is None else _captured(
        lib.mx_rnn_cell_fwd, "rnn_cell_fwd", mode=mode, N=N, H=H,
        dtype=gx.dtype, save=saved is not None, act=act)
    rc = launch(DTYPE_CODES[gx.dtype], code, RNN_ACTS[act],
                gx.device.index or 0, gx.data_ptr(), gh.data_ptr(),
                ptr(h if mode == "gru" else None),
                ptr(c if mode == "lstm" else None), h_new.data_ptr(),
                ptr(c_new), ptr(saved), N, H, stream)
    if rc != 0:
        raise _launch_failed(lib, "rnn_cell_fwd", rc)
    _count_launch("rnn_cell_fwd")
    _count_dtype("rnn_cell_fwd", gx.dtype)
    return h_new, c_new, saved


def rnn_cell_bwd_cuda(mode, saved, gh, h, c, h_new, c_new, dh, dc,
                      act="tanh"):
    """Launch the recurrent cell's backward (`csrc/rnn_cell.cu`): from what
    the forward saved (the LSTM's activations, c and c'; the GRU's
    activations, gh and h; the RNN's h') and the output gradients dh' (and
    the LSTM's dc'; None reads as zeros) compute dgx, dgh (N, G H) and the
    previous state's elementwise gradient (the LSTM's dc, the GRU's
    dh' z), as `ops.rnn.cell_bwd_ref` computes them. dgh is dgx itself
    except for the GRU, whose n block differs (dn_pre r). Returns (dgx,
    dgh, dstate or None); counts one launch in `rnn_cell_bwd_launches`.
    Raises `MXNetError` on any input the kernel does not take."""
    name = "rnn_cell_bwd_cuda"
    key = {"lstm": "c_new", "gru": "h"}.get(mode, "h_new")
    like = {"c_new": c_new, "h": h, "h_new": h_new}[key]
    if like is None:
        raise MXNetError(f"{name}: {mode} needs {key}")
    if like.dim() != 2:
        raise MXNetError(f"{name}: {key} must be (N, H); got "
                         f"{tuple(like.shape)}")
    G = RNN_GATES.get(mode, 1)
    N, H = like.shape
    lstm, gru = mode == "lstm", mode == "gru"
    rows, state = (N, G * H), (N, H)
    _rnn_check(name, mode, act, {
        "saved": (saved if mode != "rnn" else None, rows, mode != "rnn"),
        "gh": (gh if gru else None, rows, gru),
        "h": (h if gru else None, state, gru),
        "c": (c if lstm else None, state, lstm),
        "c_new": (c_new if lstm else None, state, lstm),
        "h_new": (h_new if mode == "rnn" else None, state, mode == "rnn"),
        "dh": (dh, state, False), "dc": (dc if lstm else None, state, False)})
    code = RNN_MODES[mode]
    dgx = torch.empty((N, G * H), dtype=like.dtype, device=like.device)
    dgh = torch.empty_like(dgx) if gru else dgx
    dstate = torch.empty_like(like) if mode != "rnn" else None
    if N * H == 0:
        return dgx, dgh, dstate
    lib = _load("rnn_cell")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(like.device).cuda_stream
    launch = lib.mx_rnn_cell_bwd if _CAPTURE is None else _captured(
        lib.mx_rnn_cell_bwd, "rnn_cell_bwd", mode=mode, N=N, H=H,
        dtype=like.dtype, dc=dc is not None, act=act)
    rc = launch(DTYPE_CODES[like.dtype], code, RNN_ACTS[act],
                like.device.index or 0,
                ptr(saved if mode != "rnn" else None), ptr(gh if gru else None),
                ptr(h if gru else None), ptr(c if lstm else None),
                ptr(h_new if mode == "rnn" else None),
                ptr(c_new if lstm else None), ptr(dh),
                ptr(dc if lstm else None), dgx.data_ptr(),
                ptr(dgh if gru else None), ptr(dstate), N, H, stream)
    if rc != 0:
        raise _launch_failed(lib, "rnn_cell_bwd", rc)
    _count_launch("rnn_cell_bwd")
    _count_dtype("rnn_cell_bwd", like.dtype)
    return dgx, dgh, dstate


# ---------------------------------------------------------------------------
# the recurrent layer's whole time loop (csrc/rnn_layer.cu; the plain
# versions are ops/rnn.py :: layer_fwd_ref / layer_bwd_ref)
# ---------------------------------------------------------------------------
# the card a route is decided for by default: the H100 SXM's SMs, and the
# shared memory one block may take (227 KB)
RNN_LAYER_SMS = 132
RNN_LAYER_SMEM = 232448
# csrc/rnn_layer.cu: warps a block, batch rows a product pass, the ring's
# bytes (2 stages of 32 rows of 512 + 16 bytes), the most product rows of a
# forward block (G U, padded to 4) and units of a backward block
_RL_WARPS, _RL_TILE, _RL_RING = 8, 32, 2 * 32 * (512 + 16)
_RL_FWD_ROWS, _RL_BWD_ROWS = 64, 16


def _rl_smem(rows, K, item):
    """Shared bytes of a block (csrc/rnn_layer.cu :: layer_smem): `rows`
    rows of K values, each padded to 16 bytes, then the ring, which the
    warps' partial sums reuse."""
    vk = 16 // item
    return rows * (-(-K // vk) * vk) * item + max(
        _RL_WARPS * rows * _RL_TILE * 4, _RL_RING)


def rnn_layer_plan(mode, H, dtype, sms=RNN_LAYER_SMS):
    """How `csrc/rnn_layer.cu` splits a (layer, direction) of `mode` at
    hidden size H >= 1 and `dtype` over `sms` SMs: {"units": hidden units a
    block, "rows": a forward block's product rows (G units, padded to 4),
    "blocks", "smem_fwd" / "smem_bwd": shared bytes a block}."""
    G = RNN_GATES[mode]
    item = torch.empty(0, dtype=dtype).element_size()
    units = -(-max(H, 1) // sms)
    rows = -(-G * units // 4) * 4
    return {"units": units, "rows": rows, "blocks": -(-max(H, 1) // units),
            "smem_fwd": _rl_smem(rows, H, item),
            "smem_bwd": _rl_smem(units, G * H, item)}


def rnn_layer_route(mode, N, H, dtype, sms=RNN_LAYER_SMS):
    """Which route `ops.nn.rnn` takes for a (layer, direction) of `mode`
    ("lstm", "gru", "rnn") at batch N, hidden size H and `dtype`, decided
    from those values (and the card's SM count, the H100's by default):
    "persistent", the whole time loop in one launch of `csrc/rnn_layer.cu`
    each way, when a block's share of W_hh (G ceil(H / sms) rows of H
    values) fits in its shared memory beside the ring and the partial sums
    (RNN_LAYER_SMEM in all; at most 16 units a block); else "per_step",
    the recurrent product and `csrc/rnn_cell.cu` once a step. Any N takes
    either: the batch runs in passes of 32 rows. On the H100: the word LM
    (LSTM, H 650, float32) persistent; a float32 LSTM at H 1500 (288 KB of
    W_hh a block) per_step; the same in bfloat16 (144 KB) persistent."""
    if H < 1:
        return "per_step"
    p = rnn_layer_plan(mode, H, dtype, sms)
    fits = (p["units"] <= _RL_BWD_ROWS and p["rows"] <= _RL_FWD_ROWS
            and max(p["smem_fwd"], p["smem_bwd"]) <= RNN_LAYER_SMEM)
    return "persistent" if fits else "per_step"


def rnn_sms(device):
    """The SM count of the card `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def count_per_step_layer():
    """Count one (layer, direction) pass of `ops.nn.rnn` on the card that
    took the "per_step" route."""
    _count_launch("rnn_layer_per_step")


def _rl_units(name, mode, H, dtype, device):
    """Hidden units a block takes on `device`; raises where the layer does
    not take the persistent route on that card."""
    sms = rnn_sms(device)
    if rnn_layer_route(mode, 1, H, dtype, sms) != "persistent":
        raise MXNetError(f"{name}: a {mode} layer at H {H} in {dtype} does "
                         f"not fit a block's shared memory over {sms} SMs "
                         f"(rnn_layer_route: per_step)")
    return rnn_layer_plan(mode, H, dtype, sms)["units"]


def _rl_shape(name, mode, w):
    """(G, H) of W_hh (G H, H) for `mode`."""
    if mode not in RNN_MODES:
        raise MXNetError(f"{name}: mode {mode!r} not one of "
                         f"{sorted(RNN_MODES)}")
    G = RNN_GATES[mode]
    if w.dim() != 2 or w.shape[0] != G * w.shape[1]:
        raise MXNetError(f"{name}: w must be ({G} H, H); got "
                         f"{tuple(w.shape)}")
    return G, w.shape[1]


def rnn_layer_fwd_cuda(mode, gx, w, h0, c0=None, bh=None, act="tanh",
                       reverse=False, save=True):
    """Launch the recurrent layer's forward (`csrc/rnn_layer.cu`): every
    step of one (layer, direction), the time axis walked backwards with
    `reverse`, as `ops.rnn.layer_fwd_ref` computes it. gx (T, N, G H): the
    input product and bias of every step; w: W_hh (G H, H); h0 (N, H); c0
    (N, H) the LSTM's; bh (G H,) the GRU's (kept in its recurrent
    product). With `save` the LSTM and the GRU also write what the backward
    reads: the gate activations (T, N, G H) and `aux` (T, N, H), the
    LSTM's c or the GRU's n block of the recurrent product at each step.
    Every tensor contiguous, of one float dtype, on one card; the shape
    must take the "persistent" route (`rnn_layer_route`) on that card.
    Returns (ys (T, N, H), h_T, c_T or None, activations or None, aux or
    None); counts one launch in `rnn_layer_fwd_launches` and
    `rnn_layer_persistent_launches`. Raises `MXNetError` on any input the
    kernel does not take."""
    name = "rnn_layer_fwd_cuda"
    G, H = _rl_shape(name, mode, w)
    if gx.dim() != 3:
        raise MXNetError(f"{name}: gx must be (T, N, {G * H}); got "
                         f"{tuple(gx.shape)}")
    T, N = gx.shape[0], gx.shape[1]
    lstm, gru = mode == "lstm", mode == "gru"
    dt = _rnn_check(name, mode, act, {
        "gx": (gx, (T, N, G * H), True), "w": (w, (G * H, H), True),
        "h0": (h0, (N, H), True),
        "c0": (c0 if lstm else None, (N, H), lstm),
        "bh": (bh if gru else None, (G * H,), gru)})
    dev = gx.device
    ys = torch.empty((T, N, H), dtype=dt, device=dev)
    h_out = torch.empty((N, H), dtype=dt, device=dev)
    c_out = torch.empty_like(h_out) if lstm else None
    keep = save and mode != "rnn"
    acts = torch.empty_like(gx) if keep else None
    aux = torch.empty_like(ys) if keep else None
    if T < 1:
        raise MXNetError(f"{name}: the layer needs T >= 1 steps")
    if N * H == 0:
        return ys, h_out, c_out, acts, aux
    units = _rl_units(name, mode, H, dt, dev)
    lib = _load("rnn_layer")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lib.mx_rnn_layer_fwd if _CAPTURE is None else _captured(
        lib.mx_rnn_layer_fwd, "rnn_layer_fwd", mode=mode, T=T, N=N, H=H,
        dtype=dt, save=keep, act=act)
    rc = launch(DTYPE_CODES[dt], RNN_MODES[mode], RNN_ACTS[act],
                dev.index or 0, int(bool(reverse)), units, gx.data_ptr(),
                w.data_ptr(), h0.data_ptr(), ptr(c0 if lstm else None),
                ptr(bh if gru else None), ys.data_ptr(), h_out.data_ptr(),
                ptr(c_out), ptr(acts), ptr(aux), T, N, H, stream)
    if rc != 0:
        raise _launch_failed(lib, "rnn_layer_fwd", rc)
    _count_launch("rnn_layer_fwd", "rnn_layer_persistent")
    _count_dtype("rnn_layer_fwd", dt)
    return ys, h_out, c_out, acts, aux


def rnn_layer_bwd_cuda(mode, w, acts, aux, ys, h0, c0, dys, dh_T, dc_T,
                       act="tanh", reverse=False):
    """Launch the recurrent layer's backward (`csrc/rnn_layer.cu`), as
    `ops.rnn.layer_bwd_ref` computes it: from W_hh, what the forward saved
    (the activations and aux; the RNN none), ys, h0, the LSTM's c0 and the
    output gradients dys (T, N, H), dh_T and the LSTM's dc_T (N, H) (any
    None: zeros) compute, in reverse time, dgx (T, N, G H): the gradient of
    every step's gate pre-activations; dgh: the recurrent product's (the
    GRU's n block dn r; dgx itself for the others); dh0 and the LSTM's dc0.
    Returns (dgx, dgh, dh0, dc0 or None); counts one launch in
    `rnn_layer_bwd_launches`. Raises `MXNetError` on any input the kernel
    does not take."""
    name = "rnn_layer_bwd_cuda"
    G, H = _rl_shape(name, mode, w)
    if ys.dim() != 3:
        raise MXNetError(f"{name}: ys must be (T, N, {H}); got "
                         f"{tuple(ys.shape)}")
    T, N = ys.shape[0], ys.shape[1]
    lstm, gru, rnn = mode == "lstm", mode == "gru", mode == "rnn"
    dt = _rnn_check(name, mode, act, {
        "w": (w, (G * H, H), True), "ys": (ys, (T, N, H), True),
        "acts": (None if rnn else acts, (T, N, G * H), not rnn),
        "aux": (None if rnn else aux, (T, N, H), not rnn),
        "h0": (h0, (N, H), True),
        "c0": (c0 if lstm else None, (N, H), lstm),
        "dys": (dys, (T, N, H), False), "dh_T": (dh_T, (N, H), False),
        "dc_T": (dc_T if lstm else None, (N, H), False)})
    dev = ys.device
    dgx = torch.empty((T, N, G * H), dtype=dt, device=dev)
    dgh = torch.empty_like(dgx) if gru else dgx
    dh0 = torch.empty((N, H), dtype=dt, device=dev)
    dc0 = torch.empty_like(dh0) if lstm else None
    if T < 1:
        raise MXNetError(f"{name}: the layer needs T >= 1 steps")
    if N * H == 0:
        return dgx, dgh, dh0, dc0
    units = _rl_units(name, mode, H, dt, dev)
    lib = _load("rnn_layer")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lib.mx_rnn_layer_bwd if _CAPTURE is None else _captured(
        lib.mx_rnn_layer_bwd, "rnn_layer_bwd", mode=mode, T=T, N=N, H=H,
        dtype=dt, dys=dys is not None, dh=dh_T is not None,
        dc=lstm and dc_T is not None, act=act)
    rc = launch(DTYPE_CODES[dt], RNN_MODES[mode], RNN_ACTS[act],
                dev.index or 0, int(bool(reverse)), units, w.data_ptr(),
                ptr(None if rnn else acts), ptr(None if rnn else aux),
                ys.data_ptr(), h0.data_ptr(), ptr(c0 if lstm else None),
                ptr(dys), ptr(dh_T), ptr(dc_T if lstm else None),
                dgx.data_ptr(), ptr(dgh if gru else None), dh0.data_ptr(),
                ptr(dc0), T, N, H, stream)
    if rc != 0:
        raise _launch_failed(lib, "rnn_layer_bwd", rc)
    _count_launch("rnn_layer_bwd")
    _count_dtype("rnn_layer_bwd", dt)
    return dgx, dgh, dh0, dc0
