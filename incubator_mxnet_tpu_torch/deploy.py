"""Deployment runtime of the PyTorch port: load and run the artifacts
`HybridBlock.export` writes.

Counterpart of the `ExportedModel` half of `incubator_mxnet_tpu/deploy.py`
(the reference's predictor: serve inference from the exported artifacts
without the model's Python class). The artifact set of a prefix:

  * `<prefix>.pt2` — a `torch.export` program of the inference forward
    whose inputs are the parameters (in the manifest's order) and then the
    data; it holds no weights and no device, so one file serves any
    weights and runs on the device its inputs are on. The fused tier's
    kernels are custom-op nodes in it (`mxtorch.scale_shift_act`,
    `mxtorch.avg_pool2d_fwd`): on the card each launches its CUDA kernel.
  * `<prefix>.params.npz` — the weights by structural name, the file
    `save_parameters` writes (and the JAX package's).
  * `<prefix>.deploy.json` — the manifest, the JAX package's fields
    (`format_version` 1, `params` in structural-name order, `n_out`,
    `single_output`, `aux_indices`, `inputs`) plus `program`, the name of
    the `.pt2` file.

Host arrays are numpy. bfloat16 has no numpy type without `ml_dtypes`, so
a bfloat16 value crosses the host boundary as float32 (exact: every
bfloat16 is a float32) and is bfloat16 on the device. The C ABI half of
the JAX module (`_capi_*`) is not ported (ROADMAP A12).
"""
from __future__ import annotations

import json
import os

import numpy as _np
import torch

from .base import MXNetError
from .device import resolve_device

__all__ = ["ExportedModel", "DTYPE_CODES", "DTYPE_TO_CODE",
           "maybe_enable_compile_cache"]

# Reference dtype codes (mshadow/base.h kFloat32..), the JAX package's;
# bfloat16 at its reference index (12).
DTYPE_CODES = {
    0: "float32", 1: "float64", 2: "float16", 3: "uint8",
    4: "int32", 5: "int8", 6: "int64", 7: "bool",
    8: "int16", 9: "uint16", 10: "uint32", 11: "uint64",
    12: "bfloat16",
}
DTYPE_TO_CODE = {v: k for k, v in DTYPE_CODES.items()}


# the `.pt2` file's own record of the parameter layout: the names whose
# `.params.npz` value is kernel dims first
LAYOUT_FILE = "mxtorch_layout.json"


def _dtype_name(code_or_name):
    if isinstance(code_or_name, (int, _np.integer)):
        name = DTYPE_CODES.get(int(code_or_name))
        if name is None:
            raise MXNetError(f"unknown dtype code {code_or_name}")
        return name
    return str(code_or_name).replace("torch.", "")


def _np_dtype(code_or_name):
    """The numpy type that carries a dtype on the host: bfloat16 travels
    as float32."""
    name = _dtype_name(code_or_name)
    return _np.dtype("float32" if name == "bfloat16" else name)


def _torch_dtype(code_or_name):
    return getattr(torch, _dtype_name(code_or_name))


def _to_host(t):
    """One device-to-host copy of a tensor, as numpy (bfloat16 widened to
    float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def maybe_enable_compile_cache():
    """The JAX package arms a persistent compilation cache here. The port
    compiles no programs (an exported program runs eagerly, and every
    process shares the package's kernel build directory), so there is
    nothing to arm: returns False."""
    return False


class ExportedModel:
    """A loaded, runnable export artifact (≙ the reference PredictorHandle).

    ::

        model = ExportedModel("model-0000")        # on the card
        out = model.run(x)                         # numpy in, numpy out

    `params=` names another `.params.npz` (another net's weights for the
    same program, no new export needed). The program runs on `device`
    (default: the card; without one, this raises); nothing falls back to
    the CPU. `run` and `call_arrays` touch no mutable state after
    construction, so one instance may serve several threads.
    """

    def __init__(self, prefix=None, *, program=None, params=None,
                 manifest=None, device=None):
        if prefix is not None:
            program = program or f"{prefix}.pt2"
            params = params or f"{prefix}.params.npz"
            manifest = manifest or f"{prefix}.deploy.json"
        if not (program and params and manifest):
            raise MXNetError(
                "ExportedModel needs a prefix or explicit program=, "
                "params=, manifest= paths")
        for p in (program, params, manifest):
            if not os.path.exists(p):
                raise MXNetError(f"export artifact missing: {p}")
        with open(manifest) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version") != 1:
            raise MXNetError(
                f"unsupported deploy manifest version "
                f"{self.manifest.get('format_version')!r}")
        self.device = resolve_device(device)
        from torch.export.passes import move_to_device_pass
        extra = {LAYOUT_FILE: ""}
        ep = torch.export.load(program, extra_files=extra)
        kernel_first = set(json.loads(extra[LAYOUT_FILE] or "{}").get(
            "kernel_first", ()))
        # any device the tracing baked in (a constant, a factory call's
        # device=) is rewritten to the one asked for
        self._program = move_to_device_pass(ep, self.device)
        # every input of an exported forward is a user input (parameters
        # first): its graph module runs as it is, without the pytree and
        # input-constraint pass of `.module()` (host ms a call at
        # ResNet-50's 320 inputs)
        from torch.export.graph_signature import InputKind
        if any(spec.kind != InputKind.USER_INPUT
               for spec in self._program.graph_signature.input_specs):
            raise MXNetError(f"{program} holds lifted state: not a "
                             f"HybridBlock.export program")
        self._call = self._program.graph_module
        specs = [n.meta["val"] for n in self._program.graph.nodes
                 if n.op == "placeholder"]
        names = self.manifest["params"]
        if len(specs) != len(names) + len(self.manifest["inputs"]):
            raise MXNetError(
                f"{program} takes {len(specs)} inputs; the manifest lists "
                f"{len(names)} parameters and "
                f"{len(self.manifest['inputs'])} inputs")
        with _np.load(params, allow_pickle=False) as loaded:
            try:
                arrays = [loaded[n] for n in names]
            except KeyError as e:
                raise MXNetError(
                    f"parameter {e} listed in manifest but absent from "
                    f"{params}") from e
        self._pbufs = tuple(
            self._param_tensor(a, spec, name, name in kernel_first)
            for name, a, spec in zip(names, arrays, specs))
        self.n_out = int(self.manifest["n_out"])
        self.single_output = bool(self.manifest["single_output"])
        self.input_specs = [
            (tuple(d["shape"]), d["dtype"]) for d in self.manifest["inputs"]]
        self._runs = set()

    def _param_tensor(self, a, spec, name, kernel_first):
        """A parameter on the device in the layout the program was traced
        with: the traced dtype and strides (a channels-last convolution's
        weight keeps its memory format), from the file's values. The file
        holds a channels-last convolution's weight kernel dims first, as
        `save_parameters` writes it (`kernel_first`, recorded in the
        program file at export); the program takes (O, I/g, *k)."""
        v = torch.from_numpy(_np.array(a, copy=True))
        if kernel_first:
            n = v.dim()
            v = v.permute(n - 1, n - 2, *range(n - 2))
        if tuple(v.shape) != tuple(spec.shape):
            raise MXNetError(f"parameter {name}: file shape "
                             f"{tuple(a.shape)} does not fit the program's "
                             f"{tuple(spec.shape)}")
        t = torch.empty_strided(tuple(spec.shape), tuple(spec.stride()),
                                dtype=spec.dtype, device=self.device)
        t.copy_(v)
        return t

    @property
    def num_inputs(self):
        return len(self.input_specs)

    @property
    def output_arity(self):
        return self.n_out

    @property
    def batch_size(self):
        """Leading dim of the first exported input (the batch bucket this
        artifact serves; exports are static-shape programs)."""
        return int(self.input_specs[0][0][0])

    def warmup(self):
        """Run once on zeros ahead of traffic (the kernels build and the
        libraries pick their algorithms here, not on a request). Returns
        self."""
        self.run(*[_np.zeros(s, dtype=_np_dtype(d))
                   for s, d in self.input_specs])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def lowered(self, *inputs):
        """The `torch.export.ExportedProgram` that `run` executes (its graph
        holds the kernels' custom-op nodes). `inputs` are optional; when
        given they must match `input_specs` — the program is fixed-shape."""
        if inputs:
            self._check_inputs(inputs)
        return self._program

    def compile_cache_size(self):
        """Distinct input shapes run so far: 1 after warmup (an exported
        program is fixed-shape, so it never grows past that)."""
        return len(self._runs)

    def _check_inputs(self, inputs):
        if len(inputs) != len(self.input_specs):
            raise MXNetError(
                f"model takes {len(self.input_specs)} inputs, "
                f"got {len(inputs)}")
        out = []
        for i, (x, (shape, dtype)) in enumerate(
                zip(inputs, self.input_specs)):
            if isinstance(x, torch.Tensor):
                t = x
            else:
                t = torch.from_numpy(_np.ascontiguousarray(
                    getattr(x, "asnumpy", lambda: x)()))
            if tuple(t.shape) != shape:
                raise MXNetError(
                    f"input {i}: shape {tuple(t.shape)} != exported "
                    f"{shape} (exports are static-shape programs)")
            out.append(t.to(device=self.device, dtype=_torch_dtype(dtype)))
        return out

    def _forward(self, tensors):
        self._runs.add(tuple(tuple(t.shape) for t in tensors))
        with torch.no_grad():
            out = self._call(*self._pbufs, *tensors)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def run(self, *inputs):
        """Execute the exported forward: numpy (or tensors) in, numpy out
        (one device-to-host copy an output); an array or a tuple."""
        outs = tuple(_to_host(o) for o in
                     self._forward(self._check_inputs(inputs)))
        return outs[0] if self.single_output else outs

    def call_arrays(self, *arrs):
        """The forward over tensors on the device, no host copy: returns
        the raw output tuple (SymbolBlock's path)."""
        return self._forward(self._check_inputs(arrs))
