"""PyTorch port: the flagship transformer LM (`models.transformer`) against
the JAX package's, on the CPU, from the same weights (`params_from_jax`).

Config: vocab 512, 2 layers, d_model 64, 4 heads, d_ff 128, T 32, batch 2.
Limits ("relative": a leaf's max |port - jax| over its max |jax|; for the
optimizer's results, ||port - jax|| / ||jax|| over each leaf):
  * float32: logits and loss within 1e-5; the gradients of the loss within
    1e-5; three `make_train_step` AdamW steps within 1e-5 (the losses;
    params and both moments by the leaf's norm), at Adam eps 1e-6. Adam
    normalizes each element's step, m / (sqrt(v) + eps): an element whose
    gradient is a near-cancelling sum (an embedding row the batch barely
    touches, |g| ~ 1e-7) carries the two libraries' float32 summation
    orders as a relative error of 10% or more, and its step as much of a
    learning rate. At the default eps (1e-8) that flips whole steps of a
    few elements; at 1e-6 it stays a few 1e-6 of a leaf's largest value,
    which the norm of the leaf averages with its thousands of well-posed
    elements. The gradients themselves hold at 1e-5 whatever eps.
  * the dense MoE (num_experts=2, with its aux loss): the same limits.
  * bfloat16 compute (float32 masters): logits within 2e-2 (a few steps of
    bfloat16 through 2 layers), losses within 1e-3 and params after two
    steps within 2e-2: each side rounds its own products to bfloat16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.models import transformer as J

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.models import transformer as T

torch.set_num_threads(1)

SMALL = dict(vocab_size=512, num_layers=2, d_model=64, num_heads=4,
             d_ff=128, max_seq_len=64)
B, SEQ = 2, 32


def _configs(dtype="float32", **kw):
    return (J.TransformerConfig(**SMALL, dtype=dtype, **kw),
            T.TransformerConfig(**SMALL, dtype=dtype, **kw))


def _pair(cfgj, seed=0):
    pj = J.init_params(jax.random.PRNGKey(seed), cfgj)
    pnp = jax.tree_util.tree_map(np.asarray, pj)
    return pj, T.params_from_jax(pnp, device="cpu")


def _tokens(seed=0, n=SEQ + 1):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], (B, n)).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _leaves_j(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _leaves_t(tree):
    # the port's leaf order: dict keys sorted, as jax.tree_util's
    return [x.detach().float().numpy() for x in T._leaves(tree)]


def _norm_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_trees(got, want, limit, what, rel=_rel):
    gl, wl = _leaves_t(got), _leaves_j(want)
    assert len(gl) == len(wl)
    worst = max(rel(g, w) for g, w in zip(gl, wl))
    assert worst <= limit, f"{what}: {worst:.3g} > {limit}"


@pytest.mark.parametrize("experts", [0, 2])
def test_forward_and_loss_float32(experts):
    cfgj, cfgt = _configs(num_experts=experts)
    pj, pt = _pair(cfgj)
    toks = _tokens()
    lj, aj = J.forward(pj, jnp.asarray(toks[:, :-1]), cfgj, return_aux=True)
    lt, at = T.forward(pt, torch.from_numpy(toks[:, :-1]), cfgt,
                       return_aux=True)
    assert lt.dtype == torch.float32 and lt.shape == (B, SEQ, 512)
    assert _rel(lt.numpy(), lj) <= 1e-5
    assert _rel(at.numpy(), aj) <= 1e-5
    Lj = J.loss_fn(pj, {"tokens": jnp.asarray(toks)}, cfgj)
    Lt = T.loss_fn(pt, {"tokens": torch.from_numpy(toks)}, cfgt)
    assert _rel(Lt.item(), Lj) <= 1e-5


@pytest.mark.parametrize("experts", [0, 2])
def test_gradients_float32(experts):
    cfgj, cfgt = _configs(num_experts=experts)
    pj, pt = _pair(cfgj, seed=1)
    toks = _tokens(1)
    gj = jax.grad(lambda p: J.loss_fn(p, {"tokens": jnp.asarray(toks)},
                                      cfgj))(pj)
    leaves = [p.requires_grad_(True) for p in T._leaves(pt)]
    loss = T.loss_fn(T._unflatten(pt, leaves),
                     {"tokens": torch.from_numpy(toks)}, cfgt)
    gt = T._unflatten(pt, torch.autograd.grad(loss, leaves))
    _assert_trees(gt, gj, 1e-5, "gradients")


@pytest.mark.parametrize("experts", [0, 2])
def test_three_adamw_steps_float32(experts):
    cfgj, cfgt = _configs(num_experts=experts)
    pj, pt = _pair(cfgj, seed=2)
    stepj = J.make_train_step(cfgj, eps=1e-6)
    stept = T.make_train_step(cfgt, eps=1e-6)
    oj, ot = J.init_opt_state(pj), T.init_opt_state(pt)
    for s in range(3):
        toks = _tokens(10 + s)
        pj, oj, Lj = stepj(pj, oj, {"tokens": jnp.asarray(toks)},
                           jnp.int32(s))
        pt, ot, Lt = stept(pt, ot, {"tokens": torch.from_numpy(toks)}, s)
        assert _rel(Lt.item(), Lj) <= 1e-5, f"loss of step {s}"
    _assert_trees(pt, pj, 1e-5, "params", _norm_rel)
    _assert_trees(ot[0], oj[0], 1e-5, "first moments", _norm_rel)
    _assert_trees(ot[1], oj[1], 1e-5, "second moments", _norm_rel)


def test_bfloat16_compute_within_its_limit():
    cfgj, cfgt = _configs("bfloat16")
    pj, pt = _pair(cfgj, seed=3)
    toks = _tokens(3)
    lj = J.forward(pj, jnp.asarray(toks[:, :-1]), cfgj)
    lt = T.forward(pt, torch.from_numpy(toks[:, :-1]), cfgt)
    assert lt.dtype == torch.bfloat16
    assert _rel(lt.float().numpy(), np.asarray(lj.astype(jnp.float32))) \
        <= 2e-2
    stepj, stept = J.make_train_step(cfgj), T.make_train_step(cfgt)
    oj, ot = J.init_opt_state(pj), T.init_opt_state(pt)
    for s in range(2):
        toks = _tokens(20 + s)
        pj, oj, Lj = stepj(pj, oj, {"tokens": jnp.asarray(toks)},
                           jnp.int32(s))
        pt, ot, Lt = stept(pt, ot, {"tokens": torch.from_numpy(toks)}, s)
        assert _rel(Lt.item(), Lj) <= 1e-3, f"loss of step {s}"
    assert all(p.dtype == torch.float32 for p in T._leaves(pt))
    _assert_trees(pt, pj, 2e-2, "bf16 params")


def test_the_step_writes_new_tensors_and_never_its_inputs():
    cfgt = T.TransformerConfig(**SMALL, dtype="float32")
    params = T.init_params(0, cfgt, device="cpu")
    opt = T.init_opt_state(params)
    before = [t.clone() for t in T._leaves((params, opt))]
    toks = torch.from_numpy(_tokens(4))
    new_p, new_opt, loss = T.make_train_step(cfgt)(params, opt,
                                                   {"tokens": toks}, 0)
    assert all(torch.equal(a, b)
               for a, b in zip(T._leaves((params, opt)), before))
    old_ptrs = {t.data_ptr() for t in T._leaves((params, opt))}
    assert not old_ptrs & {t.data_ptr() for t in T._leaves((new_p,
                                                            new_opt))}
    assert not loss.requires_grad and torch.isfinite(loss)
    assert not any(t.requires_grad for t in T._leaves((new_p, new_opt)))


def test_init_params_layout_matches_jax_and_is_device_independent():
    cfgj, cfgt = _configs(tie_embeddings=False, num_experts=2)
    pj = J.init_params(jax.random.PRNGKey(0), cfgj)
    pt = T.init_params(0, cfgt, device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: tuple(x.shape), tree)
    assert shapes(pt) == shapes(pj)
    assert all(t.dtype == torch.float32 for t in T._leaves(pt))
    again = T.init_params(0, cfgt, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(T._leaves(pt),
                                                 T._leaves(again)))
    # the JAX init's scales: embeddings 0.02, ones for the norms
    assert abs(float(pt["embedding"].std()) - 0.02) < 2e-3
    assert torch.equal(pt["layers"][0]["ln1_scale"], torch.ones(64))


def test_transformer_lm_on_ndarray_and_tensor_inputs():
    lm = T.TransformerLM(T.TransformerConfig(**SMALL, dtype="float32"))
    lm.initialize(seed=0, device="cpu")
    toks = _tokens(5, n=SEQ)
    out_t = lm(torch.from_numpy(toks))
    out_nd = lm(tmx.np.array(toks, device=tmx.cpu()))
    assert isinstance(out_t, torch.Tensor) and not out_t.requires_grad
    assert isinstance(out_nd, tmx.NDArray) and out_nd.shape == (B, SEQ, 512)
    assert torch.equal(out_nd._t, out_t)
    np.testing.assert_array_equal(
        out_t.numpy(), T.forward(lm.params, torch.from_numpy(toks),
                                 lm.cfg).detach().numpy())


def test_out_of_vocabulary_token_reads_the_clamped_row_as_jax():
    cfgj, cfgt = _configs()
    pj, pt = _pair(cfgj)
    toks = _tokens(6, n=SEQ)
    toks[0, 3], toks[1, 5] = 600, -3
    lj = J.forward(pj, jnp.asarray(toks), cfgj)
    lt = T.forward(pt, torch.from_numpy(toks), cfgt)
    assert _rel(lt.detach().numpy(), lj) <= 1e-5


def test_mesh_only_functions_raise_naming_a10():
    cfgt = T.TransformerConfig(**SMALL)
    with pytest.raises(tmx.MXNetError, match="A10"):
        T.param_shardings(cfgt, mesh=object())
    with pytest.raises(tmx.MXNetError, match="A10"):
        T.stack_pipeline_params({}, cfgt, 2)
    with pytest.raises(tmx.MXNetError, match="A10"):
        T.make_pipeline_train_step(cfgt, object(), 2)
    with pytest.raises(tmx.MXNetError, match="A10"):
        T.make_train_step(cfgt, mesh=object())
    with pytest.raises(tmx.MXNetError, match="A10"):
        T.forward({}, torch.zeros((1, 2), dtype=torch.int32), cfgt,
                  mesh=object())


def test_config_fields_and_defaults_equal_jax():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(J.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.TransformerConfig)}
    assert jf == tf
