"""PyTorch port: the recurrent cell's kernel module (`ops.rnn`, the CUDA
kernel `csrc/rnn_cell.cu` and its wrappers in `ops.kernels`) on the CPU.

  * the plain version of each mode (through `ops.nn.lstm_cell`,
    `gru_cell`, `rnn_relu_cell`: the products, then the cell step)
    against the JAX package's `ops.nn` cell functions, forward and
    gradients (`jax.grad` against torch autograd), float32, 1e-5 relative
    + 1e-6 absolute (the port adds the bias to the input product first);
  * the `torch.autograd.Function` (`ops.rnn.cell`, which on the CPU runs
    `cell_fwd_ref` / `cell_bwd_ref`) against autograd through the plain
    composition (`ops.rnn.cell_composed`), every mode and each of the six
    activations,
    with an output left out of the loss (its gradient None), float32,
    2e-6 relative + 1e-6 absolute;
  * the 16-bit plain versions computed in float32 and rounded once: within
    one step of the type of the float64 composition rounded;
  * `roofline.kernel_cost` for `rnn_cell_fwd` / `rnn_cell_bwd`, the
    vector width the kernels pick, the kernel's empty refusal table;
  * the wrappers raising for anything but CUDA tensors, and a net asked
    onto the card raising where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.gluon import rnn as trnn
from incubator_mxnet_tpu_torch.inspect import roofline
from incubator_mxnet_tpu_torch.ops import kernels
from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.ops import rnn as trnn_ops

torch.set_num_threads(1)

N, C, H = 4, 5, 7
GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _arr(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _jax_cell(mode):
    if mode == "lstm":
        def f(x, h, c, wx, wh, bx, bh):
            return jnn.lstm_cell(x, h, c, wx, wh, bx + bh)
    elif mode == "gru":
        def f(x, h, c, wx, wh, bx, bh):
            return (jnn.gru_cell(x, h, wx, wh, bx, bh),)
    else:
        def f(x, h, c, wx, wh, bx, bh):
            return (jnn.rnn_relu_cell(x, h, wx, wh, bx + bh,
                                      "relu" if mode == "rnn_relu"
                                      else "tanh"),)
    return f


def _port_cell(mode):
    if mode == "lstm":
        def f(x, h, c, wx, wh, bx, bh):
            return tnn.lstm_cell(x, h, c, wx, wh, bx + bh)
    elif mode == "gru":
        def f(x, h, c, wx, wh, bx, bh):
            return (tnn.gru_cell(x, h, wx, wh, bx, bh),)
    else:
        def f(x, h, c, wx, wh, bx, bh):
            return (tnn.rnn_relu_cell(x, h, wx, wh, bx + bh,
                                      "relu" if mode == "rnn_relu"
                                      else "tanh"),)
    return f


@pytest.mark.parametrize("mode", sorted(GATES))
def test_cell_functions_as_jax(mode):
    G = GATES[mode]
    inputs = [_arr(N, C), _arr(N, H, seed=1), _arr(N, H, seed=2),
              _arr(G * H, C, seed=3, scale=0.4),
              _arr(G * H, H, seed=4, scale=0.4),
              _arr(G * H, seed=5, scale=0.1), _arr(G * H, seed=6, scale=0.1)]
    ws = None
    jf, tf = _jax_cell(mode), _port_cell(mode)

    def jloss(*a):
        return sum((o * w).sum() for o, w in zip(jf(*a), ws))
    want = jf(*[jnp.array(a) for a in inputs])
    ws = [_arr(*np.shape(o), seed=9 + k) for k, o in enumerate(want)]
    jgrads = jax.grad(jloss, argnums=tuple(range(7)))(
        *[jnp.array(a) for a in inputs])
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = tf(*tin)
    sum((o * torch.tensor(w)).sum() for o, w in zip(got, ws)).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    for k, (t, jg) in enumerate(zip(tin, jgrads)):
        tg = np.zeros_like(inputs[k]) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-5, atol=1e-6,
                                   err_msg=f"gradient of input {k}")


@pytest.mark.parametrize("act", ["tanh", "relu", "sigmoid", "softrelu",
                                 "softsign", "log_sigmoid"])
@pytest.mark.parametrize("mode,drop", [
    ("lstm", None), ("lstm", "h"), ("lstm", "c"), ("gru", None),
    ("gru", "h"), ("rnn", None), ("rnn", "h")])
def test_function_against_autograd_of_the_composition(mode, act, drop):
    """`ops.rnn.cell` (the kernels' Function, the plain versions on the
    CPU) against autograd through `cell_composed`; `drop` leaves h' (or
    the LSTM's c') out of the loss, so its gradient reaches the backward
    as None (for the GRU and the RNN, h' alone: then nothing)."""
    G = trnn_ops.GATES[mode]
    raw = [_arr(N, G * H, seed=1), _arr(N, G * H, seed=2),
           _arr(N, H, seed=3), _arr(N, H, seed=4)]
    results = []
    for fn in (trnn_ops.cell, trnn_ops.cell_composed):
        ins = [torch.tensor(a, requires_grad=True) for a in raw]
        out = fn(mode, ins[0], ins[1], ins[2],
                 ins[3] if mode == "lstm" else None, act=act)
        out = out if isinstance(out, tuple) else (out,)
        keep = [k for k in range(len(out))
                if not (drop == "h" and k == 0 or drop == "c" and k == 1)]
        loss = sum((out[k] * torch.tensor(_arr(N, H, seed=7 + k))).sum()
                   for k in keep) if keep else (ins[0] * 0).sum()
        grads = torch.autograd.grad(loss, ins, allow_unused=True)
        results.append(([o.detach() for o in out],
                        [torch.zeros(a.shape) if g is None else g
                         for g, a in zip(grads, raw)]))
    (o1, g1), (o2, g2) = results
    for a, b in zip(o1, o2):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-6)
    for k, (a, b) in enumerate(zip(g1, g2)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-6,
                                   msg=f"gradient of input {k}")


STEP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn"])
def test_16bit_plain_version_rounds_once(mode, dtype):
    """The 16-bit plain forward is the float64 composition of the 16-bit
    inputs rounded once to the type: within one step of the type."""
    G = trnn_ops.GATES[mode]
    gx, gh, h, c = (torch.tensor(_arr(*s, seed=k)).to(dtype) for k, s in
                    enumerate(((N, G * H), (N, G * H), (N, H), (N, H))))
    got = trnn_ops.cell_fwd_ref(mode, gx, gh, h, c)
    exact = trnn_ops.cell_composed(mode, gx.double(), gh.double(),
                                   h.double(), c.double())
    exact = exact if isinstance(exact, tuple) else (exact,)
    for g, e in zip(got, exact):
        step = STEP[dtype] * e.abs().clamp(min=2.0 ** -14)
        assert g.dtype == dtype
        assert bool(((g.double() - e).abs() <= step).all())


def test_kernel_cost_rows():
    fwd = roofline.kernel_cost("rnn_cell_fwd", mode="lstm", N=32, H=650,
                               dtype=torch.float32)
    assert fwd["bytes"] == 15 * 32 * 650 * 4 and fwd["compute"] == "float32"
    assert fwd["flops"] > 0
    bwd = roofline.kernel_cost("rnn_cell_bwd", mode="lstm", N=32, H=650,
                               dtype=torch.float32)
    assert bwd["bytes"] == 13 * 32 * 650 * 4
    infer = roofline.kernel_cost("rnn_cell_fwd", mode="lstm", N=32, H=650,
                                 dtype=torch.bfloat16, save=False)
    assert infer["bytes"] == 11 * 32 * 650 * 2
    for mode, f, b in (("gru", 11, 13), ("rnn", 3, 3)):
        assert roofline.kernel_cost("rnn_cell_fwd", mode=mode, N=2, H=3,
                                    dtype=torch.float16)["bytes"] \
            == f * 2 * 3 * 2
        assert roofline.kernel_cost("rnn_cell_bwd", mode=mode, N=2, H=3,
                                    dtype=torch.float16)["bytes"] \
            == b * 2 * 3 * 2
    assert roofline.kernel_cost("rnn_cell_bwd", mode="lstm", N=1, H=1,
                                dtype=torch.float32, dc=False)["bytes"] \
        == 12 * 4


@pytest.mark.parametrize("H,dtype,want", [
    (650, torch.float32, 2), (648, torch.float32, 4), (37, torch.float32, 1),
    (650, torch.bfloat16, 2), (648, torch.float16, 8), (4, torch.float16, 4)])
def test_vector_width(H, dtype, want):
    assert kernels.rnn_cell_vec(H, dtype) == want
    assert kernels.refusal("rnn_cell", H=H) is None


def test_wrappers_take_cuda_tensors_only():
    gx = torch.zeros(2, 8)
    h = torch.zeros(2, 2)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.rnn_cell_fwd_cuda("lstm", gx, gx, h, h)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.rnn_cell_bwd_cuda("lstm", gx, None, None, h, None, h, h,
                                  None)
    with pytest.raises(MXNetError, match="mode"):
        kernels.rnn_cell_fwd_cuda("lstmp", gx, gx, h, h)


def test_a_card_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is served")
    net = trnn.LSTM(4, input_size=3)
    with pytest.raises(MXNetError, match="cuda"):
        net.initialize(device="cuda")
    with pytest.raises(MXNetError, match="cuda"):
        trnn.LSTMCell(4, input_size=3).initialize()


def test_unknown_mode_and_activation_raise():
    t = torch.zeros(2, 4)
    with pytest.raises(MXNetError, match="mode"):
        trnn_ops.cell("lstmp", t, t, t[:, :1], t[:, :1])
    with pytest.raises(MXNetError, match="activation"):
        trnn_ops.cell("rnn", t, t, t, act="mish")


def test_only_a_taped_step_saves_its_activations(monkeypatch):
    """The forward writes the gate activations only where the step is
    taped: an inference step (grad mode off, or no input needing a
    gradient) asks the kernel for none."""
    seen = []
    real = trnn_ops.cell_fwd

    def spy(mode, gx, gh, h, c, act="tanh", save=True):
        seen.append(save)
        return real(mode, gx, gh, h, c, act, save)
    monkeypatch.setattr(trnn_ops, "cell_fwd", spy)
    gx = torch.tensor(_arr(2, 8), requires_grad=True)
    gh, h = torch.tensor(_arr(2, 8, seed=1)), torch.tensor(_arr(2, 2, seed=2))
    c = torch.tensor(_arr(2, 2, seed=3))
    with torch.no_grad():
        trnn_ops.cell("lstm", gx, gh, h, c)
    trnn_ops.cell("lstm", gx.detach(), gh, h, c)
    hn, cn = trnn_ops.cell("lstm", gx, gh, h, c)
    (hn.sum() + cn.sum()).backward()
    assert seen == [False, False, True]
    assert gx.grad is not None and bool(torch.isfinite(gx.grad).all())
