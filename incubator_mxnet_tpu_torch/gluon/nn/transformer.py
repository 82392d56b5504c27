"""Transformer layers of the PyTorch port (MultiHeadAttention, encoder and
decoder cells, PositionalEmbedding): the blocks GluonNLP's BERT rides on.

Counterpart of `incubator_mxnet_tpu/gluon/nn/transformer.py`, with its
structural names, its pre-norm residual order and its routing: attention
takes the flash op (`ops.attention.flash_attention`, CUDA kernels B5-B8 on
the card) when `use_flash` is set and no mask is given, and the plain
`ops.nn.scaled_dot_product_attention` composition otherwise; a decoder's
cross-attention always takes the composition. Under AMP each op casts as
the JAX package's NDArray ops do: the residual `+`, the head split's
reshape and transpose and every `Dense` run in the target dtype, the
layer norms in float32.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import attention as _attention
from ...ops import fused as _fused
from ...ops import nn as _ops
from ..block import HybridBlock
from . import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderCell",
           "TransformerDecoderCell", "PositionalEmbedding"]


class MultiHeadAttention(HybridBlock):
    """Multi-head attention over (batch, seq, units) inputs: separate
    q/k/v projections, heads of units / num_heads, output projection."""

    def __init__(self, units, num_heads, dropout=0.0, use_flash=False):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._use_flash = use_flash
        self.query_proj = Dense(units, flatten=False, in_units=units)
        self.key_proj = Dense(units, flatten=False, in_units=units)
        self.value_proj = Dense(units, flatten=False, in_units=units)
        self.out_proj = Dense(units, flatten=False, in_units=units)
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def _split(self, x):
        b, t, _ = x.shape
        return _ops.transpose(_ops.reshape(x, (b, t, self._heads, -1)),
                              (0, 2, 1, 3))

    def forward(self, query, key=None, value=None, mask=None, causal=False):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.query_proj(query))
        k = self._split(self.key_proj(key))
        v = self._split(self.value_proj(value))
        if self._use_flash and mask is None:
            b, h, t, d = q.shape
            # (b, h, t, d) -> (b*h, t, d): the reshape of the transposed
            # heads copies into the contiguous layout the kernels take, as
            # the JAX package's reshape copies; at batch 1 it is a strided
            # view, copied here (and counted)
            q, k, v = (_fused.contiguous_counted(a.reshape(b * h, -1, d))
                       for a in (q, k, v))
            o = _attention.flash_attention(q, k, v, causal=causal)
            out = o.reshape(b, h, t, d)
        else:
            out = _ops.scaled_dot_product_attention(q, k, v, mask=mask,
                                                    causal=causal)
        b, h, t, d = out.shape
        out = _ops.reshape(_ops.transpose(out, (0, 2, 1, 3)),
                           (b, t, self._units))
        out = self.out_proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Pre-norm transformer encoder layer (attention + FFN)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 activation="gelu", use_flash=False):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            use_flash=use_flash)
        self.ln1 = LayerNorm(in_channels=units)
        self.ln2 = LayerNorm(in_channels=units)
        if activation not in ("relu", "gelu"):
            raise MXNetError(f"unsupported activation {activation!r} "
                             "(relu|gelu)")
        self.ffn1 = Dense(hidden_size, flatten=False, in_units=units)
        self.ffn2 = Dense(units, flatten=False, in_units=hidden_size)
        self._act = activation
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x, mask=None):
        h = self.ln1(x)
        x = _ops.add(x, self.attention(h, mask=mask))
        h = self.ln2(x)
        h = _ops.activation(self.ffn1(h), "relu") if self._act == "relu" \
            else _ops.gelu(self.ffn1(h))
        h = self.ffn2(h)
        if self.dropout is not None:
            h = self.dropout(h)
        return _ops.add(x, h)


class TransformerDecoderCell(HybridBlock):
    """Pre-norm decoder layer: causal self-attention, cross-attention over
    `memory` (always the composition), FFN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 use_flash=False):
        super().__init__()
        self.self_attention = MultiHeadAttention(units, num_heads, dropout,
                                                 use_flash=use_flash)
        self.cross_attention = MultiHeadAttention(units, num_heads, dropout)
        self.ln1 = LayerNorm(in_channels=units)
        self.ln2 = LayerNorm(in_channels=units)
        self.ln3 = LayerNorm(in_channels=units)
        self.ffn1 = Dense(hidden_size, flatten=False, in_units=units)
        self.ffn2 = Dense(units, flatten=False, in_units=hidden_size)
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x, memory, mem_mask=None, self_mask=None):
        # self_mask excludes padded target positions (combined with causal)
        x = _ops.add(x, self.self_attention(self.ln1(x), mask=self_mask,
                                            causal=True))
        x = _ops.add(x, self.cross_attention(self.ln2(x), memory, memory,
                                             mask=mem_mask))
        h = _ops.gelu(self.ffn1(self.ln3(x)))
        h = self.ffn2(h)
        if self.dropout is not None:
            h = self.dropout(h)
        return _ops.add(x, h)


class PositionalEmbedding(HybridBlock):
    """Learned positional embedding (BERT-style), weight (max_length,
    units) drawn from `Normal(0.01)`."""

    def __init__(self, max_length, units):
        super().__init__()
        self._max_length = max_length
        self._new_param("weight", (max_length, units), "normal")

    def forward(self, x):
        t = x.shape[1]
        if t > self._max_length:
            raise MXNetError(f"sequence length {t} exceeds max_length "
                             f"{self._max_length}")
        return _ops.add(x, _ops.reshape(self.weight[:t], (1, t, -1)))
