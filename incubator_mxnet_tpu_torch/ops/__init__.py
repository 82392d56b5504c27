"""Operators of the PyTorch port: hand-written CUDA kernels (`kernels`,
sources in `csrc/`), the ops that dispatch to them with their plain
versions (`fused`, and flash attention in `attention`), and the plain
torch ops the Gluon layers use (`nn`)."""
from . import attention, fused, kernels, nn

__all__ = ["attention", "fused", "kernels", "nn"]
