"""Fused ops of the PyTorch port: each a hand-written CUDA kernel for
tensors on the card and a plain PyTorch version for tensors on the CPU.

Counterpart of `incubator_mxnet_tpu/ops/fused.py`. The dispatch is by the
device of the tensors alone: a CPU tensor takes the plain version, a CUDA
tensor takes the kernel or raises. No environment variable, exception
handler or shape test sends a CUDA tensor to the plain version (the JAX
package's `MXNET_USE_FUSION` switch and untileable-shape fallback are not
carried over). The plain versions are also the oracles the kernels are
held against on the card.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import kernels

__all__ = ["paged_attention", "paged_attention_ref"]


def paged_attention_ref(q, k_slab, v_slab, lengths, layer):
    """Plain paged decode attention over the serve KV-pool slab. Reads the
    WHOLE (S, T) page of each lane and masks to `[0, lengths + j]` for
    chunk query j; f32 arithmetic inside, output in q's dtype.

    `q`: (S, C, H, D) — C chunk queries per lane at positions
    `lengths[s] + j`. `k_slab`/`v_slab`: (rows, layers, T, H, D) with
    rows > S (lane s reads row s), possibly a view cut on the position
    axis. `lengths`: (S,) integer."""
    s_lanes, c, _h, d = q.shape
    t = k_slab.shape[2]
    kk = k_slab[:s_lanes, layer].float()
    vv = v_slab[:s_lanes, layer].float()
    scores = torch.einsum("schd,sthd->shct", q.float(), kk) * (
        1.0 / float(d) ** 0.5)
    pos = torch.arange(t, device=q.device)
    lim = lengths.to(device=q.device, dtype=torch.int64)[:, None] \
        + torch.arange(c, device=q.device)[None, :]             # (S, C)
    mask = pos[None, None, :] <= lim[:, :, None]                 # (S, C, T)
    scores = scores.masked_fill(~mask[:, None], -1e30)
    att = torch.einsum("shct,sthd->schd", torch.softmax(scores, dim=-1), vv)
    return att.to(q.dtype)


def paged_attention(q, k_slab, v_slab, lengths, layer):
    """Paged decode attention over the slotted KV slab — the serve
    engine's per-layer attention read, in place (no per-layer copy of the
    cache). CUDA tensors launch the kernel (`ops/csrc/paged_attention.cu`),
    CPU tensors take `paged_attention_ref`."""
    dev = q.device.type
    if dev == "cuda":
        return kernels.paged_attention_cuda(q, k_slab, v_slab, lengths,
                                            layer)
    if dev == "cpu":
        return paged_attention_ref(q, k_slab, v_slab, lengths, layer)
    raise MXNetError(f"paged_attention: no path for device {q.device}")
