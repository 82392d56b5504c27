"""gluon.rnn of the PyTorch port: recurrent cells and fused recurrent
layers.

Counterpart of `incubator_mxnet_tpu/gluon/rnn/__init__.py`, with its
names, parameter names (`i2h_weight`, `l0_h2h_bias`, `r1_i2h_weight`, ...)
and weight layouts ((G H, in) and (G H, H), the conv cells' (G C, C_in,
*kernel)), so `gluon.params_from_jax` carries a JAX net's values across.
Every cell and fused layer takes its gate products with `torch.matmul` /
`addmm` (the conv cells with the port's convolution) and its elementwise
step through `ops.rnn.cell`: the CUDA kernel (`csrc/rnn_cell.cu`) for
tensors on the card, its plain version on the CPU. The fused layers run
`ops.nn.rnn`, a loop over time whose input product is one product over all
time steps.

As every port block, a cell runs on tensors (NDArrays in, NDArrays out);
`begin_state` returns NDArrays on the device of the cell's parameters.
`unroll` steps the cell in a Python loop, as the JAX package's eager
unroll does. Dropout (`DropoutCell`, `ZoneoutCell`,
`VariationalDropoutCell`, the fused layers' `dropout`) draws its masks
from the port's generator of the device (`mx.random`), not from
`jax.random`, so the masks differ from the JAX package's.

The conv cells take the kernel's activations: `npx.activation`'s tanh,
relu, sigmoid, softrelu, softsign and log_sigmoid; "mish" raises, on
every device (its derivative is not a function of its output, which is
what the kernel keeps for the backward).
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...device import resolve_device
from ...ndarray import NDArray, _unwrap, _wrap
from ...numpy_extension import _dropout, _sequence_mask
from ...ops import nn as _nn
from ...ops import rnn as _rnn
from ..block import HybridBlock

__all__ = [
    "RecurrentCell", "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
    "HybridSequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
    "BidirectionalCell", "VariationalDropoutCell", "LSTMPCell",
    "RNN", "LSTM", "GRU",
]


def _is_nd(x):
    if isinstance(x, (list, tuple)):
        return any(_is_nd(v) for v in x)
    return type(x) is NDArray


def _wrap_like(nd, x):
    """`x` (a tensor, or lists of them) as NDArrays when `nd`."""
    if not nd:
        return x
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap_like(True, v) for v in x)
    return _wrap(x) if isinstance(x, torch.Tensor) else x


def _params_device(block):
    """The device of the block's parameters (drawn, or waiting for their
    shape), else the current device."""
    for p in block.collect_params().values():
        if p._data is not None:
            return p._data.device
        if p._deferred_init is not None and p._deferred_init[3] is not None:
            return p._deferred_init[3]
    return resolve_device(None)


def _zero_states(block, infos, func=None, **kwargs):
    if func is not None:
        return [func(shape=info["shape"], **kwargs) for info in infos]
    dev = _params_device(block)
    return [_wrap(torch.zeros(info["shape"], device=dev)) for info in infos]


class RecurrentCell(HybridBlock):
    """Base recurrent cell (≙ rnn_cell.py RecurrentCell)."""

    def __init__(self):
        super().__init__()
        self._modified = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial zero states, NDArrays on the parameters' device (or
        `func(shape=..., **kwargs)` each)."""
        return _zero_states(self, self.state_info(batch_size), func,
                            **kwargs)

    def reset(self):
        pass

    def forward(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell over the time axis of `inputs` (a tensor of
        `layout`, or a list of per-step tensors); returns (outputs merged
        along the time axis, or their list with merge_outputs=False,
        states). `valid_length` zeroes the merged outputs past each
        sequence's length."""
        nd = _is_nd(inputs) or _is_nd(begin_state)
        inputs, valid_length = _unwrap(inputs), _unwrap(valid_length)
        axis = layout.find("T")
        batch_axis = layout.find("N")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch = seq[0].shape[batch_axis if batch_axis < axis else 0]
        else:
            batch = inputs.shape[batch_axis]
            if axis != 0:
                inputs = inputs.swapaxes(0, axis)
            seq = [inputs[t] for t in range(length)]
        states = _unwrap(begin_state if begin_state is not None
                         else self.begin_state(batch))
        outputs = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            merged = torch.stack(outputs, dim=axis)
            if valid_length is not None:
                merged = _sequence_mask(merged, valid_length,
                                        use_sequence_length=True, axis=axis)
            return _wrap_like(nd, merged), _wrap_like(nd, states)
        return _wrap_like(nd, outputs), _wrap_like(nd, states)


class _BaseFusedGateCell(RecurrentCell):
    """Shared plumbing for RNN/LSTM/GRU cells: i2h/h2h weights + biases."""

    def __init__(self, hidden_size, num_gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros"):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = num_gates
        self._new_param("i2h_weight", (ng * hidden_size, input_size),
                        i2h_weight_initializer)
        self._new_param("h2h_weight", (ng * hidden_size, hidden_size),
                        h2h_weight_initializer)
        self._new_param("i2h_bias", (ng * hidden_size,), i2h_bias_initializer)
        self._new_param("h2h_bias", (ng * hidden_size,), h2h_bias_initializer)

    def infer_shape(self, inputs, *states):
        p = self._reg_params["i2h_weight"]
        p.shape = (p.shape[0], inputs.shape[-1])


class RNNCell(_BaseFusedGateCell):
    """Simple Elman cell (≙ rnn_cell.py RNNCell:304)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0, **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        out = _nn.rnn_relu_cell(
            inputs, states[0], self.i2h_weight, self.h2h_weight,
            self.i2h_bias + self.h2h_bias,
            "relu" if self._activation == "relu" else "tanh")
        return out, [out]


class LSTMCell(_BaseFusedGateCell):
    """≙ rnn_cell.py LSTMCell:413 (gate order i,f,g,o)."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        h, c = _nn.lstm_cell(inputs, states[0], states[1], self.i2h_weight,
                             self.h2h_weight, self.i2h_bias + self.h2h_bias)
        return h, [h, c]


class GRUCell(_BaseFusedGateCell):
    """≙ rnn_cell.py GRUCell:540 (gate order r,z,n)."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        out = _nn.gru_cell(inputs, states[0], self.i2h_weight,
                           self.h2h_weight, self.i2h_bias, self.h2h_bias)
        return out, [out]


class LSTMPCell(RecurrentCell):
    """LSTM with hidden projection (≙ rnn_cell.py LSTMPCell:1284)."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros"):
        super().__init__()
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._new_param("i2h_weight", (4 * hidden_size, input_size),
                        i2h_weight_initializer)
        self._new_param("h2h_weight", (4 * hidden_size, projection_size),
                        h2h_weight_initializer)
        self._new_param("h2r_weight", (projection_size, hidden_size),
                        h2r_weight_initializer)
        self._new_param("i2h_bias", (4 * hidden_size,), i2h_bias_initializer)
        self._new_param("h2h_bias", (4 * hidden_size,), h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, inputs, *states):
        p = self._reg_params["i2h_weight"]
        p.shape = (p.shape[0], inputs.shape[-1])

    def forward(self, inputs, states):
        h, c = _nn.lstm_cell(inputs, states[0], states[1], self.i2h_weight,
                             self.h2h_weight, self.i2h_bias + self.h2h_bias)
        r = torch.matmul(h, self.h2r_weight.t())
        return r, [r, c]


# ---------------------------------------------------------------------------
# modifier / composite cells
# ---------------------------------------------------------------------------
class SequentialRNNCell(RecurrentCell):
    """Stack cells vertically (≙ rnn_cell.py SequentialRNNCell:670)."""

    def __init__(self, *cells):
        super().__init__()
        for c in cells:
            self.add(c)

    def add(self, cell):
        self.register_child(cell)

    def _cells(self):
        return [m for m in self._modules.values()
                if isinstance(m, RecurrentCell)]

    def state_info(self, batch_size=0):
        out = []
        for c in self._cells():
            out.extend(c.state_info(batch_size))
        return out

    def begin_state(self, batch_size=0, func=None, **kwargs):
        states = []
        for c in self._cells():
            states.extend(c.begin_state(batch_size, func, **kwargs))
        return states

    def __len__(self):
        return len(self._cells())

    def __getitem__(self, i):
        return self._cells()[i]

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells():
            n = len(cell.state_info())
            cell_states = states[pos:pos + n]
            pos += n
            inputs, new_s = cell(inputs, cell_states)
            next_states.extend(new_s)
        return inputs, next_states


HybridSequentialRNNCell = SequentialRNNCell


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.base_cell.begin_state(batch_size, func, **kwargs)


def _keep_mask(p, like):
    """A dropout mask of rate p shaped like `like`: 1/(1-p) where kept, 0
    elsewhere, from the device's generator."""
    return _dropout(torch.ones_like(like), p,
                    _random.generator(like.device), None)


class DropoutCell(RecurrentCell):
    """≙ rnn_cell.py DropoutCell:838 (training mode only)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0 and autograd.is_training():
            inputs = _dropout(inputs, self._rate,
                              _random.generator(inputs.device),
                              self._axes or None)
        return inputs, states


class ZoneoutCell(_ModifierCell):
    """≙ rnn_cell.py ZoneoutCell:935 — stochastically preserve prior states."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        self._prev_output = None

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        if autograd.is_training():
            # a kept position takes the new value, the others the previous
            if self._zo > 0:
                prev = self._prev_output if self._prev_output is not None \
                    else torch.zeros_like(out)
                out = torch.where(_keep_mask(self._zo, out) != 0, out, prev)
            if self._zs > 0:
                new_states = [
                    torch.where(_keep_mask(self._zs, ns) != 0, ns, s)
                    for ns, s in zip(new_states, states)]
        self._prev_output = out
        return out, new_states


class ResidualCell(_ModifierCell):
    """≙ rnn_cell.py ResidualCell:984."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class VariationalDropoutCell(_ModifierCell):
    """≙ rnn_cell.py VariationalDropoutCell:1110 — one dropout mask reused
    across time steps (until `reset()`)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._mask_in = self._mask_out = self._mask_states = None

    def reset(self):
        self._mask_in = self._mask_out = self._mask_states = None

    @staticmethod
    def _mask(cached, p, like):
        return _keep_mask(p, like) if cached is None else cached

    def forward(self, inputs, states):
        if autograd.is_training():
            if self._di > 0:
                self._mask_in = self._mask(self._mask_in, self._di, inputs)
                inputs = inputs * self._mask_in
            if self._ds > 0:
                self._mask_states = self._mask(self._mask_states, self._ds,
                                               states[0])
                states = [states[0] * self._mask_states] + list(states[1:])
        out, states = self.base_cell(inputs, states)
        if autograd.is_training() and self._do > 0:
            self._mask_out = self._mask(self._mask_out, self._do, out)
            out = out * self._mask_out
        return out, states


class BidirectionalCell(RecurrentCell):
    """≙ rnn_cell.py BidirectionalCell:1029 — unroll-only composite."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return (self.l_cell.begin_state(batch_size, func, **kwargs)
                + self.r_cell.begin_state(batch_size, func, **kwargs))

    def forward(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        nd = _is_nd(inputs) or _is_nd(begin_state)
        inputs = _unwrap(inputs)
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            if axis != 0:
                inputs = inputs.swapaxes(0, axis)
            seq = [inputs[t] for t in range(length)]
        else:
            seq = list(inputs)
        batch = seq[0].shape[0]
        states = _unwrap(begin_state if begin_state is not None
                         else self.begin_state(batch))
        nl = len(self.l_cell.state_info())
        l_states, r_states = states[:nl], states[nl:]
        l_outs, l_states = self.l_cell.unroll(length, seq, l_states,
                                              merge_outputs=False)
        r_outs, r_states = self.r_cell.unroll(length, list(reversed(seq)),
                                              r_states, merge_outputs=False)
        outs = [torch.cat([lo, ro], dim=-1)
                for lo, ro in zip(l_outs, reversed(r_outs))]
        states = list(l_states) + list(r_states)
        if merge_outputs is None or merge_outputs:
            return (_wrap_like(nd, torch.stack(outs, dim=axis)),
                    _wrap_like(nd, states))
        return _wrap_like(nd, outs), _wrap_like(nd, states)


# ---------------------------------------------------------------------------
# fused multi-layer recurrent layers (≙ rnn_layer.py → fused rnn op)
# ---------------------------------------------------------------------------
class _FusedRNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        ng = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode]
        self._gates = ng
        for layer in range(num_layers):
            for d in range(self._dir):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self._dir
                pre = f"{'lr'[d]}{layer}_"
                self._new_param(pre + "i2h_weight", (ng * hidden_size, in_sz),
                                i2h_weight_initializer)
                self._new_param(pre + "h2h_weight",
                                (ng * hidden_size, hidden_size),
                                h2h_weight_initializer)
                self._new_param(pre + "i2h_bias", (ng * hidden_size,),
                                i2h_bias_initializer)
                self._new_param(pre + "h2h_bias", (ng * hidden_size,),
                                h2h_bias_initializer)

    def infer_shape(self, inputs, *args):
        in_sz = inputs.shape[-1]
        for layer in range(self._num_layers):
            for d in range(self._dir):
                p = self._reg_params[f"{'lr'[d]}{layer}_i2h_weight"]
                layer_in = in_sz if layer == 0 else self._hidden_size * self._dir
                p.shape = (p.shape[0], layer_in)

    def state_info(self, batch_size=0):
        L = self._num_layers * self._dir
        shape = (L, batch_size, self._hidden_size)
        if self._mode == "lstm":
            return [{"shape": shape}, {"shape": shape}]
        return [{"shape": shape}]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return _zero_states(self, self.state_info(batch_size), func,
                            **kwargs)

    def __call__(self, inputs, states=None, **kwargs):
        return super().__call__(inputs, *([states] if states is not None
                                          else []))

    def forward(self, inputs, states=None):
        time_major = self._layout == "TNC"
        explicit_states = states is not None
        batch = inputs.shape[1] if time_major else inputs.shape[0]
        if states is None:
            states = [torch.zeros(i["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for i in self.state_info(batch)]
        if isinstance(states, torch.Tensor):
            states = [states]
        x = inputs if time_major else inputs.swapaxes(0, 1)
        params = {}
        for layer in range(self._num_layers):
            for d in range(self._dir):
                pre = f"{'lr'[d]}{layer}_"
                params[(layer, d)] = {
                    k: getattr(self, pre + n) for k, n in (
                        ("wx", "i2h_weight"), ("wh", "h2h_weight"),
                        ("bx", "i2h_bias"), ("bh", "h2h_bias"))}
        training = autograd.is_training()
        gen = _random.generator(x.device) \
            if (self._dropout > 0 and training) else None
        out, new_states = _nn.rnn(x, params, tuple(states), mode=self._mode,
                                  num_layers=self._num_layers,
                                  bidirectional=self._dir == 2,
                                  dropout_rate=self._dropout, generator=gen,
                                  training=training)
        if not time_major:
            out = out.swapaxes(0, 1)
        if explicit_states:
            return out, list(new_states)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size} -> "
                f"{self._hidden_size}, layers={self._num_layers}, "
                f"bidirectional={self._dir == 2})")


class RNN(_FusedRNNLayer):
    """≙ rnn_layer.py RNN:260."""

    def __init__(self, hidden_size, num_layers=1, activation="tanh", **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, **kwargs)


class LSTM(_FusedRNNLayer):
    """≙ rnn_layer.py LSTM:353."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, **kwargs)


class GRU(_FusedRNNLayer):
    """≙ rnn_layer.py GRU:480."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("gru", hidden_size, num_layers, **kwargs)


# ---------------------------------------------------------------------------
# Convolutional recurrent cells (≙ python/mxnet/gluon/rnn/conv_rnn_cell.py:
# Conv{1D,2D,3D}{RNN,LSTM,GRU}Cell — gates computed by convolutions over
# spatially-structured states). The gates of a step, (N, G C, *spatial)
# channels-first, are (N, G (C prod(spatial))) row-major: the cell kernel's
# layout, each gate block C prod(spatial) wide.
# ---------------------------------------------------------------------------
class _ConvGateCell(RecurrentCell):
    """Shared conv-gate plumbing. input_shape is (C, *spatial) — required
    up front (the reference also needs it: state shape depends on it)."""

    _MODE = None

    def __init__(self, input_shape, hidden_channels, num_gates,
                 i2h_kernel=(3, 3), h2h_kernel=(3, 3),
                 i2h_pad=None, conv_layout="NCHW",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 activation="tanh"):
        super().__init__()
        if not conv_layout.startswith("NC"):
            raise MXNetError("conv cells use channel-first layouts")
        self._input_shape = tuple(input_shape)
        self._hc = hidden_channels
        self._ng = num_gates
        nd = len(self._input_shape) - 1
        derived_layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]
        if conv_layout not in ("NCHW", derived_layout):
            # "NCHW" is the reference default arg; anything else must
            # match the rank implied by input_shape
            raise MXNetError(
                f"conv_layout {conv_layout!r} does not match input_shape "
                f"{input_shape} (expected {derived_layout!r})")

        def _t(v):
            return (v,) * nd if isinstance(v, int) else tuple(v)
        self._i2h_kernel = _t(i2h_kernel)
        self._h2h_kernel = _t(h2h_kernel)
        if any(k % 2 == 0 for k in self._i2h_kernel + self._h2h_kernel):
            # even kernels break the recurrence: k//2 padding would grow
            # the state spatially every step
            raise MXNetError(
                "conv cell kernels must be odd so SAME padding keeps "
                f"state spatial dims constant; got i2h={self._i2h_kernel} "
                f"h2h={self._h2h_kernel}")
        if activation not in _rnn.ACTS:
            raise MXNetError(f"conv recurrent cells take the cell kernel's "
                             f"activations {sorted(_rnn.ACTS)}; got "
                             f"{activation!r}")
        # SAME padding so state spatial dims stay constant
        self._i2h_pad = _t(i2h_pad) if i2h_pad is not None else tuple(
            k // 2 for k in self._i2h_kernel)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        self._act = activation
        in_c = self._input_shape[0]
        self._spatial = self._input_shape[1:]
        self._layout = derived_layout
        self._new_param("i2h_weight",
                        (num_gates * hidden_channels, in_c) + self._i2h_kernel,
                        i2h_weight_initializer)
        self._new_param("h2h_weight",
                        (num_gates * hidden_channels, hidden_channels)
                        + self._h2h_kernel, h2h_weight_initializer)
        self._new_param("i2h_bias", (num_gates * hidden_channels,),
                        i2h_bias_initializer)
        self._new_param("h2h_bias", (num_gates * hidden_channels,),
                        h2h_bias_initializer)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hc) + self._spatial
        n_states = 2 if self._ng == 4 else 1
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-len(
            self._spatial):]} for _ in range(n_states)]

    def _gates(self, inputs, h):
        """(gi, gh) flattened to (N, G C prod(spatial)) each."""
        gi = _nn.convolution(inputs, self.i2h_weight, self.i2h_bias,
                             pad=self._i2h_pad, layout=self._layout)
        gh = _nn.convolution(h, self.h2h_weight, self.h2h_bias,
                             pad=self._h2h_pad, layout=self._layout)
        return gi.flatten(1), gh.flatten(1)

    def forward(self, inputs, states):
        gi, gh = self._gates(inputs, states[0])
        flat = [s.flatten(1) for s in states]
        out = _rnn.cell(self._MODE, gi, gh, flat[0],
                        flat[1] if self._MODE == "lstm" else None,
                        act=self._act)
        shape = states[0].shape
        if self._MODE == "lstm":
            h, c = (t.reshape(shape) for t in out)
            return h, [h, c]
        out = out.reshape(shape)
        return out, [out]


class _ConvRNNCellImpl(_ConvGateCell):
    _MODE = "rnn"

    def __init__(self, input_shape, hidden_channels, **kw):
        super().__init__(input_shape, hidden_channels, 1, **kw)


class _ConvLSTMCellImpl(_ConvGateCell):
    _MODE = "lstm"

    def __init__(self, input_shape, hidden_channels, **kw):
        super().__init__(input_shape, hidden_channels, 4, **kw)


class _ConvGRUCellImpl(_ConvGateCell):
    _MODE = "gru"

    def __init__(self, input_shape, hidden_channels, **kw):
        super().__init__(input_shape, hidden_channels, 3, **kw)


def _conv_cell_family(impl, suffix):
    """1D/2D/3D named classes over one implementation (kernel rank comes
    from input_shape; the named classes validate it, reference-style)."""
    classes = {}
    for nd, name in ((1, "Conv1D"), (2, "Conv2D"), (3, "Conv3D")):
        def _make(nd=nd, name=name):
            class Cell(impl):
                def __init__(self, input_shape, hidden_channels,
                             i2h_kernel=3, h2h_kernel=3, **kw):
                    if len(tuple(input_shape)) != nd + 1:
                        raise MXNetError(
                            f"{name}{suffix} needs input_shape of "
                            f"(C, {'x'.join('S' * nd)}), got {input_shape}")
                    if isinstance(i2h_kernel, int):
                        i2h_kernel = (i2h_kernel,) * nd
                    if isinstance(h2h_kernel, int):
                        h2h_kernel = (h2h_kernel,) * nd
                    super().__init__(input_shape, hidden_channels,
                                     i2h_kernel=i2h_kernel,
                                     h2h_kernel=h2h_kernel, **kw)
            Cell.__name__ = f"{name}{suffix}"
            Cell.__qualname__ = Cell.__name__
            Cell.__doc__ = (f"≙ rnn.conv_rnn_cell.{name}{suffix} "
                            "(conv_rnn_cell.py)")
            return Cell
        classes[f"{name}{suffix}"] = _make()
    return classes


for _cls_name, _cls in {**_conv_cell_family(_ConvRNNCellImpl, "RNNCell"),
                        **_conv_cell_family(_ConvLSTMCellImpl, "LSTMCell"),
                        **_conv_cell_family(_ConvGRUCellImpl, "GRUCell")
                        }.items():
    globals()[_cls_name] = _cls
    __all__.append(_cls_name)
del _cls_name, _cls
