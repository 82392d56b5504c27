"""Operators of the PyTorch port: hand-written CUDA kernels (`kernels`,
sources in `csrc/`) and the dispatchers with their plain versions
(`fused`)."""
from . import fused, kernels

__all__ = ["fused", "kernels"]
