"""The pretrained-weight store of the PyTorch port: local files only.

Counterpart of `incubator_mxnet_tpu/gluon/model_zoo/model_store.py`, with
its own copy of the format code (the port imports nothing of the JAX
package). Nothing is downloaded: `get_model_file(name, root)` resolves
`<root>/<name>.npz` (the zoo's own container, `save_parameters`' format)
or `<root>/<name>.params` (the reference's binary format), and
`pretrained=True` on any model-zoo constructor loads from there through
`load_pretrained`. The default root is `$MXNET_HOME/models` (MXNET_HOME
defaults to `~/.mxnet`).

The reference's binary format (what `load_params_file` reads and
`save_params_file` writes, byte for byte as the JAX package does):

  file   := u64 0x112 | u64 0 | vec<ndarray> | vec<string names>
  vec<T> := u64 count | T...
  string := u64 length | bytes
  ndarray(V2/V3) := u32 magic (0xF993fac9 | 0xF993faca) | i32 stype
                  | shape | ctx (i32 dev_type, i32 dev_id) | i32 type_flag
                  | raw data
  shape  := i32 ndim | i64 * ndim
  type_flag (mshadow): 0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64,
                       7 bool, 8 i16, 9 u16, 10 u32, 11 u64, 12 bf16

V1 records (magic 0xF993fac8) and the legacy ones (the magic is the ndim,
u32 dims) are read too; bf16 is widened to float32 on reading; sparse
records are refused.
"""
from __future__ import annotations

import os
import struct

import numpy as _np
import torch

from ...base import MXNetError

__all__ = ["get_model_file", "load_params_file", "save_params_file",
           "convert_params_to_npz", "load_pretrained", "auto_name_map"]

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA
_V1_MAGIC = 0xF993FAC8

_DTYPE_OF_FLAG = {0: _np.float32, 1: _np.float64, 2: _np.float16,
                  3: _np.uint8, 4: _np.int32, 5: _np.int8, 6: _np.int64,
                  7: _np.bool_, 8: _np.int16, 9: _np.uint16,
                  10: _np.uint32, 11: _np.uint64}
_BF16_FLAG = 12   # stored as raw uint16, widened to float32
_FLAG_OF_DTYPE = {_np.dtype(v): k for k, v in _DTYPE_OF_FLAG.items()}


def _widen_bf16(raw_u16):
    # bfloat16 is float32's top 16 bits
    return (raw_u16.astype(_np.uint32) << 16).view(_np.float32)


def default_root():
    return os.path.expanduser(
        os.environ.get("MXNET_HOME",
                       os.path.join("~", ".mxnet")) + "/models")


def get_model_file(name, root=None):
    """The local weight file of `name` under `root`: `<name>.npz` first,
    else `<name>.params`. Raises `MXNetError` when neither is there."""
    root = root or default_root()
    for ext in (".npz", ".params"):
        p = os.path.join(root, name + ext)
        if os.path.exists(p):
            return p
    raise MXNetError(
        f"no pretrained weights for {name!r} under {root} "
        f"(looked for {name}.npz / {name}.params). This build has no "
        "network egress: place a weight file there, or convert a reference "
        "checkpoint with tools/convert_model.py")


# ---------------------------------------------------------------------------
# the reference's .params format
# ---------------------------------------------------------------------------
class _Reader:
    def __init__(self, data):
        self.d = data
        self.i = 0

    def take(self, n):
        if n < 0 or self.i + n > len(self.d):
            raise MXNetError("truncated .params file")
        out = self.d[self.i:self.i + n]
        self.i += n
        return out

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]


def _read_one_ndarray(r):
    magic = r.u32()
    if magic in (_V2_MAGIC, _V3_MAGIC):
        if r.i32() != 0:      # not the default (dense) storage
            raise MXNetError("sparse arrays in .params are unsupported "
                             "(cast_storage the checkpoint first)")
        ndim = r.i32()
        if ndim == -1:        # a V3 "none" record: nothing follows
            return _np.zeros((), _np.float32)
        shape = struct.unpack(f"<{ndim}q", r.take(8 * ndim))
    elif magic == _V1_MAGIC:
        ndim = r.i32()
        shape = struct.unpack(f"<{ndim}q", r.take(8 * ndim))
    else:
        # legacy: the magic is the ndim, the dims are u32
        ndim = magic
        if ndim > 32:
            raise MXNetError(f"corrupt .params (ndim={ndim})")
        shape = struct.unpack(f"<{ndim}I", r.take(4 * ndim))
    if len(shape) == 0 and magic != _V3_MAGIC:
        # a zero ndim is "none" outside V3: no context, type or data
        return _np.zeros((), _np.float32)
    r.i32()   # context: device type
    r.i32()   # context: device id
    flag = r.i32()
    n = int(_np.prod(shape)) if shape else 1
    if flag == _BF16_FLAG:
        raw = _np.frombuffer(r.take(n * 2), dtype=_np.uint16)
        return _widen_bf16(raw).reshape(shape).copy()
    if flag not in _DTYPE_OF_FLAG:
        raise MXNetError(f"unsupported dtype flag {flag} in .params")
    dt = _np.dtype(_DTYPE_OF_FLAG[flag])
    return _np.frombuffer(r.take(n * dt.itemsize),
                          dtype=dt).reshape(shape).copy()


def load_params_file(path, keep_prefixes=False):
    """{name: numpy array} of a reference `.params` file. The "arg:" /
    "aux:" prefixes of Module-era files are stripped unless
    `keep_prefixes`."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != _LIST_MAGIC:
        raise MXNetError(f"{path}: not an NDArray list file (bad magic)")
    r.u64()                      # reserved
    arrays = [_read_one_ndarray(r) for _ in range(r.u64())]
    names = [r.take(r.u64()).decode() for _ in range(r.u64())]
    if names and len(names) != len(arrays):
        raise MXNetError(f"{path}: key/array count mismatch")
    if not names:
        names = [f"arg:arr_{i}" for i in range(len(arrays))]
    if keep_prefixes:
        return dict(zip(names, arrays))
    return {nm.split(":", 1)[-1]: a for nm, a in zip(names, arrays)}


def _host(arr):
    """A numpy array, an NDArray or a tensor as a numpy array (bfloat16
    widened to float32)."""
    if hasattr(arr, "asnumpy"):
        arr = arr.asnumpy()
    elif hasattr(arr, "detach"):
        t = arr.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    # asarray keeps a 0-d array 0-d
    return _np.asarray(arr)


def save_params_file(path, params):
    """Write {name: array} (numpy arrays, NDArrays or tensors) as a
    reference `.params` file (V2 records, a 0-d array as V3, the CPU
    context); a type the format lacks (bfloat16 among them) is written as
    float32. Returns `path`."""
    out = bytearray()
    out += struct.pack("<QQ", _LIST_MAGIC, 0)
    items = list(params.items())
    out += struct.pack("<Q", len(items))
    for _, arr in items:
        arr = _host(arr)
        if not arr.flags["C_CONTIGUOUS"]:
            arr = _np.copy(arr, order="C")
        if arr.dtype not in _FLAG_OF_DTYPE:
            arr = arr.astype(_np.float32)
        # a zero ndim means "none" under V2, so a 0-d array goes as V3
        out += struct.pack("<I", _V3_MAGIC if arr.ndim == 0 else _V2_MAGIC)
        out += struct.pack("<i", 0)                      # default storage
        out += struct.pack("<i", arr.ndim)
        out += struct.pack(f"<{arr.ndim}q", *arr.shape)
        out += struct.pack("<ii", 1, 0)                  # cpu:0
        out += struct.pack("<i", _FLAG_OF_DTYPE[arr.dtype])
        out += arr.tobytes()
    out += struct.pack("<Q", len(items))
    for nm, _ in items:
        b = nm.encode()
        out += struct.pack("<Q", len(b)) + b
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def convert_params_to_npz(params_path, npz_path, name_map=None):
    """A reference `.params` checkpoint as the zoo's `.npz`, its names
    renamed by `name_map` ({reference name: structural name}) where
    given."""
    params = load_params_file(params_path)
    if name_map:
        params = {name_map.get(k, k): v for k, v in params.items()}
    _np.savez(npz_path, **params)
    return npz_path


def load_pretrained(net, name, root=None):
    """Load `name`'s local weights (`get_model_file`) into `net`: an
    `.npz` through `load_parameters`, a `.params` file's arrays through
    `load_dict`. Returns `net`."""
    path = get_model_file(name, root)
    if path.endswith(".params"):
        net.load_dict(load_params_file(path), _where=f"file {path}")
    else:
        net.load_parameters(path)
    return net


def auto_name_map(params_path, model_name):
    """{checkpoint name: structural name} of a reference checkpoint of the
    zoo architecture `model_name`, aligned in construction order with a
    shape check on every pair (Module-era files: their args against the
    trainable parameters, their auxs against the rest). Raises on any
    mismatch."""
    from . import vision

    factory = getattr(vision, model_name, None)
    if factory is None:
        raise MXNetError(f"unknown model-zoo architecture {model_name!r}")
    net = factory(device="cpu")
    side = 299 if "inception" in model_name else 224
    net(torch.zeros((1, 3, side, side)))
    ours = list(net.collect_params().items())

    raw = load_params_file(params_path, keep_prefixes=True)
    if any(k.startswith(("arg:", "aux:")) for k in raw):
        their_args = [(k.split(":", 1)[1], v) for k, v in raw.items()
                      if k.startswith("arg:")]
        their_auxs = [(k.split(":", 1)[1], v) for k, v in raw.items()
                      if k.startswith("aux:")]
        our_args = [(n, p) for n, p in ours if p.grad_req != "null"]
        our_auxs = [(n, p) for n, p in ours if p.grad_req == "null"]
        groups = [(their_args, our_args, "arg"),
                  (their_auxs, our_auxs, "aux")]
    else:
        groups = [(list(raw.items()), ours, "param")]

    mapping = {}
    for theirs, ours_group, kind in groups:
        if len(theirs) != len(ours_group):
            raise MXNetError(
                f"{params_path}: {len(theirs)} {kind} arrays vs "
                f"{len(ours_group)} in {model_name} — architecture "
                "mismatch (or extra/missing aux states)")
        for (their_name, their_arr), (our_name, our_p) in zip(theirs,
                                                              ours_group):
            shape = net._file_layout(our_name, our_p.data()).shape
            if tuple(their_arr.shape) != tuple(shape):
                raise MXNetError(
                    f"shape mismatch aligning {their_name!r} "
                    f"{tuple(their_arr.shape)} -> {our_name!r} "
                    f"{tuple(shape)}; the checkpoint is not "
                    f"{model_name} (pass explicit --rename entries)")
            mapping[their_name] = our_name
    return mapping
