"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The JAX package `incubator_mxnet_tpu` is the reference; this package
follows its layout and names module by module, imports `torch` and never
JAX or the JAX package. Its entry points run on the card (`cuda`) unless
the caller passes `device="cpu"`. Every TPU (Pallas) kernel on a ported
path is a hand-written CUDA kernel here (`ops/csrc/`), built with `nvcc`
at first use.

Ported so far: greedy continuous-batching serving (`serve`) on the
paged-attention CUDA kernel.
"""
from .base import MXNetError, get_env
from .device import default_device, resolve_device
from . import ops, serve

__all__ = ["MXNetError", "get_env", "default_device", "resolve_device",
           "ops", "serve"]
