"""PyTorch port: the recurrent layer's kernel module (`ops.rnn.layer`, the
CUDA kernels `csrc/rnn_layer.cu` and their wrappers in `ops.kernels`) on
the CPU.

  * `ops.nn.rnn` on the "persistent" route (the `_Layer` Function, whose
    CPU path runs `layer_fwd_ref` / `layer_bwd_ref`) against the JAX
    package's `ops.nn.rnn` forward and `jax.vjp` gradients, every mode,
    one and two directions, 2 layers (T 5, N 3, H 7, input 4; values from
    `torch_port_utils.recurrent_value`), float32 within 1e-5;
  * the same in bfloat16 and float16 (the port in the type, the JAX
    package in float32 on the same rounded values): the outputs within 8
    steps of the type at their largest value (each of the 2 x 5 steps
    rounds h once, half a step, through weights of norm about 1);
  * `ops.rnn.layer` against the per-step composition under autograd
    (`layer_composed`), every mode, both directions, with an output left
    out of the loss (its gradient None), within 1e-6 of each tensor's
    largest value;
  * `rnn_layer_route`'s table, `kernel_cost` at the word LM's layer, the
    per-step route through `ops.nn.rnn`, and the wrappers refusing CPU
    tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.inspect import roofline
from incubator_mxnet_tpu_torch.ops import kernels
from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.ops import rnn as trnn_ops

from torch_port_utils import recurrent_value

torch.set_num_threads(1)

T, N, C, H, L = 5, 3, 4, 7, 2
GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}
STEP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _inputs(mode, bidirectional, seed=0):
    """numpy (x, params, state) of a 2-layer net: weights N(0, 1) /
    sqrt(fan-in), biases 0.1 N(0, 1), x and the states N(0, 1)."""
    G, D = GATES[mode], 2 if bidirectional else 1
    rng = np.random.RandomState(seed)
    params = {}
    for layer in range(L):
        insz = C if layer == 0 else H * D
        for d in range(D):
            params[(layer, d)] = {
                k: recurrent_value(name, shape, rng) for k, name, shape in (
                    ("wx", "i2h_weight", (G * H, insz)),
                    ("wh", "h2h_weight", (G * H, H)),
                    ("bx", "i2h_bias", (G * H,)),
                    ("bh", "h2h_bias", (G * H,)))}
    x = rng.randn(T, N, C).astype(np.float32)
    state = [rng.randn(L * D, N, H).astype(np.float32)]
    if mode == "lstm":
        state.append(rng.randn(L * D, N, H).astype(np.float32))
    return x, params, state


def _flat(x, params, state):
    keys = sorted(params)
    leaves = [x] + [params[k][n] for k in keys
                    for n in ("wx", "wh", "bx", "bh")] + list(state)
    return keys, leaves


def _unflat(keys, leaves, n_state):
    x, rest = leaves[0], leaves[1:]
    params = {k: dict(zip(("wx", "wh", "bx", "bh"), rest[4 * i:4 * i + 4]))
              for i, k in enumerate(keys)}
    return x, params, tuple(rest[4 * len(keys):4 * len(keys) + n_state])


def _jax_run(mode, bidirectional, x, params, state, cots):
    """The JAX package's outputs (out, states...) and the vjp of
    sum_k (out_k * cot_k) over every input leaf, as numpy."""
    keys, leaves = _flat(x, params, state)

    def f(*lv):
        xx, pp, ss = _unflat(keys, lv, len(state))
        out, new = jnn.rnn(xx, pp, ss, mode=mode, num_layers=L,
                           hidden_size=H, bidirectional=bidirectional)
        return (out,) + tuple(new)
    outs, vjp = jax.vjp(f, *[jnp.array(a) for a in leaves])
    grads = vjp(tuple(jnp.array(c) for c in cots))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_run(mode, bidirectional, x, params, state, cots, dtype):
    keys, leaves = _flat(x, params, state)
    tl = [torch.tensor(a).to(dtype).requires_grad_(True) for a in leaves]
    xx, pp, ss = _unflat(keys, tl, len(state))
    out, new = tnn.rnn(xx, pp, ss, mode=mode, num_layers=L, hidden_size=H,
                       bidirectional=bidirectional)
    outs = (out,) + tuple(new)
    grads = torch.autograd.grad(
        sum((o.float() * torch.tensor(c)).sum() for o, c in zip(outs, cots)),
        tl)
    return ([o.detach().float().numpy() for o in outs],
            [g.float().numpy() for g in grads])


def _cotangents(mode, bidirectional, seed=9):
    D = 2 if bidirectional else 1
    rng = np.random.RandomState(seed)
    shapes = [(T, N, H * D)] + [(L * D, N, H)] * (2 if mode == "lstm" else 1)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.fixture
def layer_calls(monkeypatch):
    """The plain versions' calls on the layer route, by direction."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = trnn_ops.layer_fwd_ref, trnn_ops.layer_bwd_ref

    def spy_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def spy_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    monkeypatch.setattr(trnn_ops, "layer_fwd_ref", spy_fwd)
    monkeypatch.setattr(trnn_ops, "layer_bwd_ref", spy_bwd)
    return calls


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", sorted(GATES))
def test_layer_route_as_jax(mode, bidirectional, layer_calls):
    x, params, state = _inputs(mode, bidirectional)
    cots = _cotangents(mode, bidirectional)
    want, jgrads = _jax_run(mode, bidirectional, x, params, state, cots)
    got, tgrads = _port_run(mode, bidirectional, x, params, state, cots,
                            torch.float32)
    D = 2 if bidirectional else 1
    assert layer_calls == {"fwd": L * D, "bwd": L * D}
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"output {k}")
    for k, (g, w) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"gradient of input leaf {k}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", sorted(GATES))
def test_16bit_layer_route_as_jax(mode, bidirectional, dtype):
    x, params, state = _inputs(mode, bidirectional)
    rounded = lambda a: torch.tensor(a).to(dtype).float().numpy()  # noqa
    x = rounded(x)
    params = {k: {n: rounded(v) for n, v in p.items()}
              for k, p in params.items()}
    state = [rounded(s) for s in state]
    cots = _cotangents(mode, bidirectional)
    want, _ = _jax_run(mode, bidirectional, x, params, state, cots)
    got, _ = _port_run(mode, bidirectional, x, params, state, cots, dtype)
    for k, (g, w) in enumerate(zip(got, want)):
        lim = 8 * STEP[dtype] * max(np.abs(w).max(), 1.0)
        assert np.abs(g - w).max() <= lim, (k, np.abs(g - w).max(), lim)


CASES = [(mode, act, drop)
         for mode, act in (("lstm", "tanh"), ("gru", "tanh"), ("rnn", "tanh"),
                           ("rnn", "relu"))
         for drop in (None, "ys", "h_T") + (("c_T",) if mode == "lstm"
                                            else ())]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mode,act,drop", CASES)
def test_layer_against_autograd_of_the_composition(mode, act, drop,
                                                   reverse):
    """`ops.rnn.layer` (the layer kernels' Function, the plain versions on
    the CPU) against autograd through `layer_composed`; `drop` leaves an
    output out of the loss, so its gradient reaches the backward as
    None."""
    G = trnn_ops.GATES[mode]
    rng = np.random.RandomState(3)
    raw = [rng.randn(T, N, G * H), rng.randn(G * H, H) / np.sqrt(H),
           rng.randn(N, H), rng.randn(N, H), 0.1 * rng.randn(G * H)]
    ws = [torch.tensor(np.random.RandomState(7 + k).randn(*shape),
                       dtype=torch.float32)
          for k, shape in enumerate(((T, N, H), (N, H), (N, H)))]
    results = []
    for fn in (trnn_ops.layer, trnn_ops.layer_composed):
        ins = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
               for a in raw]
        out = fn(mode, ins[0], ins[1], ins[2],
                 ins[3] if mode == "lstm" else None,
                 ins[4] if mode == "gru" else None, act, reverse)
        keep = [k for k, n in enumerate(("ys", "h_T", "c_T")[:len(out)])
                if n != drop]
        loss = sum((out[k] * ws[k]).sum() for k in keep)
        grads = torch.autograd.grad(loss, ins, allow_unused=True)
        results.append(([o.detach() for o in out],
                        [torch.zeros(a.shape) if g is None else g
                         for g, a in zip(grads, raw)]))
    (o1, g1), (o2, g2) = results
    for k, (a, b) in enumerate(zip(o1 + g1, o2 + g2)):
        lim = 1e-6 * max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= lim, (k, (a - b).abs().max())


def test_only_a_taped_layer_saves(monkeypatch):
    """The forward keeps the activations only where the layer is taped."""
    seen = []
    real = trnn_ops.layer_fwd

    def spy(*a):
        seen.append(a[-1])
        return real(*a)
    monkeypatch.setattr(trnn_ops, "layer_fwd", spy)
    rng = np.random.RandomState(4)
    gx = torch.tensor(rng.randn(T, N, 4 * H), dtype=torch.float32,
                      requires_grad=True)
    w = torch.tensor(rng.randn(4 * H, H) / np.sqrt(H), dtype=torch.float32)
    h0, c0 = (torch.tensor(rng.randn(N, H), dtype=torch.float32)
              for _ in range(2))
    with torch.no_grad():
        trnn_ops.layer("lstm", gx, w, h0, c0)
    trnn_ops.layer("lstm", gx.detach(), w, h0, c0)
    ys, hT, cT = trnn_ops.layer("lstm", gx, w, h0, c0)
    (ys.sum() + cT.sum()).backward()
    assert seen == [False, False, True]
    assert bool(torch.isfinite(gx.grad).all())


@pytest.mark.parametrize("mode,H_,dtype,want", [
    ("lstm", 650, torch.float32, "persistent"),      # the word LM
    ("lstm", 1500, torch.float32, "per_step"),       # 288 KB a block
    ("lstm", 1500, torch.bfloat16, "persistent"),    # 144 KB a block
    ("gru", 650, torch.float16, "persistent"),
    ("rnn", 37, torch.float32, "persistent"),
    ("rnn", 4000, torch.bfloat16, "per_step"),       # 31 units a block
    ("lstm", 1100, torch.float32, "persistent"),
    ("lstm", 1200, torch.float32, "per_step"),
])
def test_route_table(mode, H_, dtype, want):
    for n in (1, 32, 1000):                          # any N takes either
        assert kernels.rnn_layer_route(mode, n, H_, dtype) == want


def test_plan_at_the_word_lm():
    p = kernels.rnn_layer_plan("lstm", 650, torch.float32)
    assert (p["units"], p["rows"], p["blocks"]) == (5, 20, 130)
    # W_hh's share (20 rows of 650, padded to 652) and the ring
    assert p["smem_fwd"] == 20 * 652 * 4 + 2 * 32 * 528
    assert p["smem_bwd"] == 5 * 2600 * 4 + 2 * 32 * 528
    big = kernels.rnn_layer_plan("lstm", 1500, torch.bfloat16)
    assert big["units"] == 12 and 4 * 12 * 1500 * 2 == 144_000
    # the partial sums of 48 rows (48 KB) outgrow the ring
    assert big["smem_fwd"] == 48 * 1504 * 2 + 8 * 48 * 32 * 4
    assert kernels.rnn_layer_plan("rnn", 37, torch.float32)["blocks"] == 37


def test_kernel_cost_at_the_word_lm():
    Tl, Nl, Hl = 35, 32, 650
    product = 2 * Nl * Hl * 4 * Hl * Tl
    assert product == 3_785_600_000
    fwd = roofline.kernel_cost("rnn_layer_fwd", mode="lstm", T=Tl, N=Nl,
                               H=Hl, dtype=torch.float32)
    cell_f, cell_b = roofline._cell_ops("lstm", "tanh")
    assert fwd["flops"] == product + Tl * Nl * Hl * cell_f
    # gx, W_hh, h0, c0 read; ys, h_T, c_T, the activations and c written
    assert fwd["bytes"] == 4 * (Tl * Nl * 4 * Hl + 4 * Hl * Hl
                                + 4 * Nl * Hl + Tl * Nl * Hl
                                + Tl * Nl * 5 * Hl)
    assert fwd["compute"] == "float32"
    bwd = roofline.kernel_cost("rnn_layer_bwd", mode="lstm", T=Tl, N=Nl,
                               H=Hl, dtype=torch.float32)
    assert bwd["flops"] == product + Tl * Nl * Hl * cell_b
    # W_hh, the activations and c, c0, dys, dh_T, dc_T read; dgx, dh0,
    # dc0 written
    assert bwd["bytes"] == 4 * (4 * Hl * Hl + Tl * Nl * 5 * Hl + Nl * Hl
                                + Tl * Nl * Hl + 2 * Nl * Hl
                                + Tl * Nl * 4 * Hl + 2 * Nl * Hl)
    for c in (fwd, bwd):
        # operations-bound: ~0.057 ms at 67 TFLOP/s against ~0.011 ms of
        # bytes at 3.35 TB/s
        assert 0.056e-3 < c["flops"] / 67e12 < 0.058e-3
        assert 0.010e-3 < c["bytes"] / 3.35e12 < 0.012e-3
    gru = roofline.kernel_cost("rnn_layer_bwd", mode="gru", T=2, N=1, H=1,
                               dtype=torch.float16, dys=False, dh=False)
    # W, acts + aux, h0 and ys, dgx and dgh, dh0
    assert gru["bytes"] == 2 * (3 + 2 * 4 + 2 + 2 * 2 * 3 + 1)


def test_nn_rnn_per_step_route_agrees(monkeypatch):
    """`ops.nn.rnn` on the route the table names: forced onto "per_step"
    it runs the cell a step and agrees with the layer route; no launch
    counter moves on the CPU."""
    x, params, state = _inputs("gru", True)
    cots = _cotangents("gru", True)
    kernels.reset_launch_counts()
    layer = _port_run("gru", True, x, params, state, cots, torch.float32)
    monkeypatch.setattr(kernels, "rnn_layer_route",
                        lambda *a, **k: "per_step")
    steps = _port_run("gru", True, x, params, state, cots, torch.float32)
    for a, b in zip(layer[0] + layer[1], steps[0] + steps[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    counts = kernels.launch_counts()
    assert all(counts[k] == 0 for k in (
        "rnn_layer_fwd", "rnn_layer_bwd", "rnn_layer_persistent",
        "rnn_layer_per_step", "rnn_cell_fwd", "rnn_cell_bwd"))


def test_wrappers_take_cuda_tensors_only():
    gx = torch.zeros(2, 3, 8)
    w = torch.zeros(8, 2)
    h = torch.zeros(3, 2)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.rnn_layer_fwd_cuda("lstm", gx, w, h, h)
    with pytest.raises(MXNetError, match="CUDA tensors only"):
        kernels.rnn_layer_bwd_cuda("lstm", w, gx, torch.zeros(2, 3, 2),
                                   torch.zeros(2, 3, 2), h, h, None, None,
                                   None)
    with pytest.raises(MXNetError, match="mode"):
        kernels.rnn_layer_fwd_cuda("lstmp", gx, w, h, h)
    with pytest.raises(MXNetError, match="w must be"):
        kernels.rnn_layer_fwd_cuda("gru", gx, w, h, bh=torch.zeros(8))


def test_layer_needs_its_states():
    t = torch.zeros(2, 3, 8)
    with pytest.raises(MXNetError, match="c0"):
        trnn_ops.layer("lstm", t, torch.zeros(8, 2), torch.zeros(3, 2))
    with pytest.raises(MXNetError, match="bh"):
        trnn_ops.layer("gru", torch.zeros(2, 3, 6), torch.zeros(6, 2),
                       torch.zeros(3, 2))
