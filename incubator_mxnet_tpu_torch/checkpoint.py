"""mx.checkpoint of the PyTorch port — checkpoint/resume with crash-consistent
commits.

Counterpart of `incubator_mxnet_tpu/checkpoint.py`, with its public names:

  * `save_checkpoint` / `load_checkpoint`: the JAX package's host-local npz
    (`__step__`, `__fmt__` 2 with the escape-safe key encoding, v1 files
    decoded by the legacy rule, the `.trainer` sidecar through
    `Trainer.save_states`), of a Block or a (nested) dict of NDArrays,
    tensors or numpy arrays. Files cross between the two packages both
    ways: a channels-last convolution's weight is written kernel dims
    first and bfloat16 as float32, as `Block.save_parameters` writes them.
  * `save_sharded` / `load_sharded`: a pytree (nested dict / list / tuple)
    of tensors, NDArrays, numpy arrays and Python scalars in the port's
    own directory format: `<dir>/<step>/TREE.json` (the structure, each
    leaf's kind, dtype and shape) and one `<i>.npy` a leaf (bfloat16 stored
    as its 16-bit pattern). The JAX package writes orbax's format there;
    the two are not interchangeable (a deliberate difference: the port
    takes no orbax). On one process the port's format is the same commit
    protocol: leaves stream into `.tmp-<step>`, which is renamed to the
    step directory and only then recorded in `MANIFEST.json`.
  * `MANIFEST_NAME`, `commit_step` (`keep_last`, `extra`), `latest_entry`,
    `latest_step` (the legacy no-manifest scan too): the manifest is the
    JAX package's, read and written by both.

All saves are crash-consistent: data is written to a temp path, fsync'd,
then committed with an atomic os.replace, and `latest_step` only trusts
committed entries — a SIGKILL (or injected IOError, see mx.fault) at any
point during a save can never lose the previous checkpoint.

Not carried over until the port has a device mesh (ROADMAP A10):
`rescale_sharded` (restore onto a different mesh), which raises;
`Repartition` keeps its name.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as _np
import torch

from .base import MXNetError
from . import fault as _fault

__all__ = ["save_checkpoint", "load_checkpoint", "save_sharded",
           "load_sharded", "rescale_sharded", "latest_step", "latest_entry",
           "commit_step", "MANIFEST_NAME", "Repartition"]


class Repartition:
    """`rescale_sharded` spec leaf for ZeRO-style ``(dp, L)`` shard views
    (the JAX package's name; restoring onto a different mesh waits for the
    port's mesh, ROADMAP A10)."""

    __slots__ = ("numel", "axis")

    def __init__(self, numel, axis="dp"):
        self.numel = int(numel)
        self.axis = axis

    def __repr__(self):
        return f"Repartition(numel={self.numel}, axis={self.axis!r})"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _norm_npz_path(path):
    """np.savez appends '.npz' to extension-less paths; normalize so save's
    return value and load agree on the real filename."""
    return path if path.endswith(".npz") else path + ".npz"


def _encode_key(k):
    """Escape-safe flat-key encoding: every '_' in the original becomes
    '_u' and every '/' becomes '_s', so names containing '__' round-trip."""
    return k.replace("_", "_u").replace("/", "_s")


def _decode_key(k):
    # every '_' in the encoded form starts a 2-char token ('_u' or '_s'),
    # so these sequential replaces cannot misalign
    return k.replace("_s", "/").replace("_u", "_")


def _host(v):
    """A leaf as a numpy array: an NDArray's or a tensor's values (bfloat16
    as float32, which numpy can hold and which round-trips exactly)."""
    t = getattr(v, "_t", v)
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return _np.asarray(v)


def save_checkpoint(path, params, step=None, trainer=None):
    """Host-local checkpoint: params (dict of NDArray/tensor/array, or a
    Block) + optional trainer state (≙ the reference's save pattern, one
    file).

    Crash-consistent: the npz (and the `.trainer` sidecar) are written to a
    temp file and committed with an atomic rename, so a partially-written
    checkpoint can never shadow a good one."""
    if hasattr(params, "collect_params"):  # a Block, in the file layout
        net = params
        params = {k: net._file_layout(k, p._data)
                  for k, p in net.collect_params().items()
                  if p._data is not None}
    payload = {_encode_key(k): _host(v) for k, v in _flatten(params).items()}
    path = _norm_npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _fault.atomic_output(path) as f:
        _np.savez(f, __step__=_np.asarray(step if step is not None else -1),
                  __fmt__=_np.asarray(2),  # v2: escape-safe key encoding
                  **payload)
        # after the temp write, before the rename commit — the real
        # crash window the atomic protocol must survive
        _fault.inject("checkpoint.save")
    if trainer is not None:
        trainer.save_states(path + ".trainer")
    return path


def load_checkpoint(path, net=None, trainer=None, device=None,
                    as_numpy=False):
    """Load a host-local checkpoint; returns (params_dict, step).

    The values come back as NDArrays on `device` (default: the current
    device), or with as_numpy=True as raw numpy arrays — bit-exact for
    every dtype (an NDArray narrows float64 to float32, as the JAX
    package's does), which crash-resume parity depends on. With `net`, each
    of its Parameters named in the file takes the file's value (in place,
    on the Parameter's device)."""
    from .ndarray import array
    _fault.inject("checkpoint.load")
    # try the npz-normalized name first (what save_checkpoint writes), then
    # the raw name (extension-less files from other tooling)
    candidates = [path] if path.endswith(".npz") \
        else [_norm_npz_path(path), path]
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        raise MXNetError(f"no checkpoint at {path!r}; tried "
                         + ", ".join(repr(c) for c in candidates))
    with _np.load(found, allow_pickle=False) as f:
        step = int(f["__step__"])
        # v1 files (no __fmt__) used a lossy '/'->'__' mapping; decode them
        # with the legacy rule so their keys aren't silently corrupted
        fmt = int(f["__fmt__"]) if "__fmt__" in f.files else 1
        decode = _decode_key if fmt >= 2 else (lambda k: k.replace("__", "/"))
        meta = ("__step__", "__fmt__")
        raw = {decode(k): f[k].copy() for k in f.files if k not in meta}
    if net is not None:
        flat = {k.replace("/", "."): v for k, v in raw.items()}
        for name, p in net.collect_params().items():
            if name in flat:
                v = net._own_layout(name, flat[name])
                p.shape = tuple(v.shape)
                p.set_data(v)
    if trainer is not None:
        # v1 saves wrote trainer state next to the un-normalized path
        for tp in (found + ".trainer", path + ".trainer"):
            if os.path.exists(tp):
                trainer.load_states(tp)
                break
    params = raw if as_numpy else {k: array(v, device=device)
                                   for k, v in raw.items()}
    return params, (step if step >= 0 else None)


# ---------------------------------------------------------------------------
# the manifest commit protocol (shared with the JAX package's directories)
# ---------------------------------------------------------------------------
MANIFEST_NAME = "MANIFEST.json"
_TREE_NAME = "TREE.json"
_TREE_FORMAT = "incubator_mxnet_tpu_torch.sharded"


def _read_manifest(directory):
    """The committed-step manifest, or None when the directory predates the
    commit protocol (legacy layout: bare step-numbered subdirs)."""
    mpath = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_manifest(directory, manifest):
    with _fault.atomic_output(os.path.join(directory, MANIFEST_NAME),
                              mode="w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def _remove_entry_payload(directory, entry):
    target = os.path.join(directory, entry.get("path") or str(entry["step"]))
    try:
        if os.path.isdir(target):
            shutil.rmtree(target)
        elif os.path.exists(target):
            os.remove(target)
        sidecar = target + ".trainer"
        if os.path.exists(sidecar):
            os.remove(sidecar)
    except OSError:
        pass  # retention GC is best-effort; the manifest entry is gone


def commit_step(directory, step, kind="sharded", path=None, keep_last=None,
                extra=None):
    """Record `step` as COMMITTED in the directory manifest (atomically),
    then apply the `keep_last` retention policy: entries beyond the newest
    N are dropped from the manifest first and their payloads deleted after,
    so a crash mid-GC can only leave orphans, never a manifest pointing at
    deleted data. `extra` (JSON-safe dict) rides on the entry — run
    counters, RNG state — and commits atomically WITH the step, so a resume
    sees counters exactly as of the restored checkpoint, never newer.
    Returns the manifest."""
    directory = os.path.abspath(directory)
    _gc_partials(directory)  # orphans from saves that died pre-commit
    manifest = _read_manifest(directory) or {"version": 1, "committed": []}
    entries = [e for e in manifest["committed"] if e["step"] != step]
    entry = {"step": int(step), "kind": kind, "path": path or str(step)}
    if extra is not None:
        entry["extra"] = extra
    entries.append(entry)
    entries.sort(key=lambda e: e["step"])
    evicted = []
    if keep_last is not None and keep_last > 0 and len(entries) > keep_last:
        evicted = entries[:-keep_last]
        entries = entries[-keep_last:]
    manifest["committed"] = entries
    _write_manifest(directory, manifest)
    for e in evicted:
        _remove_entry_payload(directory, e)
    return manifest


def _gc_partials(directory):
    """Remove orphaned partial saves a crashed writer left: `.tmp-*` scratch
    trees (sharded saves) and `.<name>*.tmp` files (atomic_output temps)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if name.startswith(".tmp-") or (name.startswith(".")
                                        and name.endswith(".tmp")):
            target = os.path.join(directory, name)
            try:
                if os.path.isdir(target):
                    shutil.rmtree(target)
                else:
                    os.remove(target)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# sharded checkpoints: the port's per-leaf directory format
# ---------------------------------------------------------------------------
def _write_leaf(path, arr):
    with open(path, "wb") as f:
        _np.save(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())


def _save_tree(tree, tmp, counter):
    """The JSON node of `tree`, writing each array leaf to `<i>.npy`."""
    if isinstance(tree, dict):
        return {"dict": {str(k): _save_tree(v, tmp, counter)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {kind: [_save_tree(v, tmp, counter) for v in tree]}
    if tree is None:
        return {"none": True}
    if isinstance(tree, (bool, int, float)) and not isinstance(
            tree, _np.generic):
        return {"scalar": tree}
    t = getattr(tree, "_t", tree)
    i = counter[0]
    counter[0] += 1
    if isinstance(t, torch.Tensor):
        kind = "ndarray" if t is not tree else "tensor"
        t = t.detach()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)      # numpy has no bfloat16: the bits
        arr = t.cpu().numpy()
    else:
        kind, arr = "numpy", _np.asarray(tree)
        dtype = arr.dtype.str
    _write_leaf(os.path.join(tmp, f"{i}.npy"), arr)
    return {"leaf": i, "kind": kind, "dtype": dtype,
            "shape": list(arr.shape)}


def save_sharded(directory, tree, step=0, keep_last=None, extra=None):
    """Save a pytree of tensors / NDArrays / numpy arrays / scalars in the
    port's per-leaf directory format (one process writes every leaf; the
    JAX package writes orbax's mesh-sharded format here).

    Crash-consistent commit protocol: leaves stream into a `.tmp-` scratch
    dir, which is atomically renamed to the step dir and only then recorded
    in MANIFEST.json — `latest_step` never sees a partial save. `keep_last=N`
    retains only the newest N committed steps."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    _gc_partials(directory)
    path = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".tmp-{step}")
    os.makedirs(tmp)
    node = _save_tree(tree, tmp, [0])
    with open(os.path.join(tmp, _TREE_NAME), "w") as f:
        json.dump({"format": _TREE_FORMAT, "version": 1, "tree": node}, f)
        f.flush()
        os.fsync(f.fileno())
    _fault.inject("checkpoint.save_sharded")
    # commit: rename the finished scratch dir over the step dir, fsync the
    # parent, then record the step in the manifest — in that order, so
    # every manifest entry always points at complete data
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fault.fsync_dir(directory)
    commit_step(directory, step, kind="sharded", keep_last=keep_last,
                extra=extra)
    return path


def _resolve_step(directory, step):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise MXNetError(f"no checkpoints under {directory}")
    return step, os.path.join(os.path.abspath(directory), str(step))


def _load_tree(node, path, like, device, where):
    if "dict" in node:
        items = node["dict"]
        if like is not None and (not isinstance(like, dict)
                                 or set(map(str, like)) != set(items)):
            raise MXNetError(f"target does not match the checkpoint's dict "
                             f"at {where or '/'} (keys {sorted(items)})")
        keys = {str(k): k for k in like} if like is not None else {}
        return {keys.get(k, k): _load_tree(
                    v, path, None if like is None else like[keys[k]],
                    device, f"{where}/{k}")
                for k, v in items.items()}
    for kind in ("list", "tuple"):
        if kind in node:
            items = node[kind]
            if like is not None and (not isinstance(like, (list, tuple))
                                     or len(like) != len(items)):
                raise MXNetError(f"target does not match the checkpoint's "
                                 f"{kind} of {len(items)} at {where or '/'}")
            out = [_load_tree(v, path, None if like is None else like[i],
                              device, f"{where}/{i}")
                   for i, v in enumerate(items)]
            return tuple(out) if kind == "tuple" else out
    if "none" in node:
        return None
    if "scalar" in node:
        return node["scalar"]
    arr = _np.load(os.path.join(path, f"{node['leaf']}.npy"),
                   allow_pickle=False)
    like_t = getattr(like, "_t", like)   # an NDArray target's tensor
    if node["kind"] == "numpy" and not isinstance(like_t, torch.Tensor):
        return arr
    t = torch.from_numpy(arr)
    if node["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)       # stored as its 16-bit pattern
    if isinstance(like_t, torch.Tensor):
        if tuple(like_t.shape) != tuple(t.shape):
            raise MXNetError(f"target shape {tuple(like_t.shape)} does not "
                             f"match the checkpoint's {tuple(t.shape)} at "
                             f"{where or '/'}")
        t = t.to(device=like_t.device, dtype=like_t.dtype)
        wrap = like_t is not like
    else:
        from .device import resolve_device
        t = t.to(resolve_device(device))
        wrap = node["kind"] == "ndarray"
    if wrap:
        from .ndarray import _wrap
        return _wrap(t)
    return t


def load_sharded(directory, step=None, target=None, device=None):
    """Restore a sharded checkpoint; returns (tree, step).

    With `target` (a tree of the saved structure), each tensor or NDArray
    leaf lands on the target leaf's device with its dtype, and each numpy
    leaf stays numpy. Without it, numpy leaves come back as numpy and
    tensor / NDArray leaves as tensors / NDArrays on `device` (default: the
    current device, the card)."""
    _fault.inject("checkpoint.load")
    step, path = _resolve_step(directory, step)
    try:
        with open(os.path.join(path, _TREE_NAME)) as f:
            meta = json.load(f)
    except OSError:
        raise MXNetError(f"{path} holds no {_TREE_NAME}: not a checkpoint of "
                         f"the port's sharded format (the JAX package "
                         f"writes orbax's there)") from None
    if meta.get("format") != _TREE_FORMAT:
        raise MXNetError(f"{path}: unknown sharded format "
                         f"{meta.get('format')!r}")
    return _load_tree(meta["tree"], path, target, device, ""), step


def latest_entry(directory):
    """The newest COMMITTED manifest entry ({step, kind, path}) whose
    payload still exists, or None. Directories without a manifest (legacy
    layout) fall back to scanning step-numbered subdirs."""
    if not os.path.isdir(directory):
        return None
    manifest = _read_manifest(directory)
    if manifest is not None:
        for e in sorted(manifest.get("committed", []),
                        key=lambda e: e["step"], reverse=True):
            if os.path.exists(os.path.join(
                    directory, e.get("path") or str(e["step"]))):
                return e
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    if not steps:
        return None
    s = max(steps)
    return {"step": s, "kind": "sharded", "path": str(s)}


def latest_step(directory):
    """Newest committed step in a checkpoint directory, or None. Only
    trusts manifest-committed entries — a save that crashed before its
    commit is invisible here."""
    entry = latest_entry(directory)
    return None if entry is None else entry["step"]


def rescale_sharded(directory, mesh, specs, step=None):
    """Elastic restart onto a DIFFERENT mesh: waits for the port's device
    mesh (ROADMAP A10) and raises."""
    raise MXNetError("checkpoint.rescale_sharded restores onto a device "
                     "mesh, which waits for the port's mesh (ROADMAP A10)")
