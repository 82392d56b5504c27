"""Operators of the PyTorch port: hand-written CUDA kernels (`kernels`,
sources in `csrc/`), the ops that dispatch to them with their plain
versions (`fused`, flash attention in `attention`, the detection sweeps in
`contrib`), the plain torch ops the Gluon layers use (`nn`), and the op
registry with its one dispatch point (`invoke`, `register_op`, `get_op`,
`list_ops`, `apply_op`, as the JAX package's `ops` exports them)."""
from . import attention, contrib, fused, kernels, nn
from .registry import apply_op, get_op, invoke, list_ops, register_op

__all__ = ["attention", "contrib", "fused", "kernels", "nn", "invoke",
           "register_op", "get_op", "list_ops", "apply_op"]
