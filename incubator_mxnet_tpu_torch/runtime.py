"""mx.runtime of the PyTorch port: feature introspection.

Counterpart of `incubator_mxnet_tpu/runtime.py`, with its keys. The values
are the port's own facts, read from the running PyTorch build and card:
`CUDA` (and `CUDNN`, `NCCL`) where a card is visible, `XLA`, `PALLAS` and
`TPU` false (the port runs neither), `SPMD` and `DIST_KVSTORE` false (the
mesh and the distributed kvstore are not ported: ROADMAP A10).
"""
from __future__ import annotations

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    cuda = torch.cuda.is_available()
    dist = torch.distributed.is_available()
    return {
        "TPU": False,
        "CPU": True,
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "F16C": True,
        "INT64_TENSOR_SIZE": True,
        "SPMD": False,
        "DIST_KVSTORE": False,
        "PROFILER": True,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and dist and torch.distributed.is_nccl_available(),
        "TENSORRT": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENCV": False,
        "OPENMP": torch.backends.openmp.is_available(),
        "SIGNAL_HANDLER": False,
        "DEBUG": False,
        "TVM_OP": False,
    }


class Features(dict):
    """{name: Feature} of the running build (≙ mx.runtime.Features())."""

    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _detect().items()})

    def is_enabled(self, name):
        return self[name.upper()].enabled

    def __repr__(self):
        return str(list(self.values()))


def feature_list():
    return list(Features().values())
