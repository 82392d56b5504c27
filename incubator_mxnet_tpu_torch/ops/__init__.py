"""Operators of the PyTorch port: hand-written CUDA kernels (`kernels`,
sources in `csrc/`), the fused ops that dispatch to them with their plain
versions (`fused`), and the plain torch ops the Gluon layers use (`nn`)."""
from . import fused, kernels, nn

__all__ = ["fused", "kernels", "nn"]
