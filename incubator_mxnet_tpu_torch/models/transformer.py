"""Transformer language model of the PyTorch port — the flagship LM.

Counterpart of `incubator_mxnet_tpu/models/transformer.py`, the
single-device half: a functional model over a params tree (nested dicts
and a list of layer dicts of float32 master tensors, cast to the compute
dtype at use), the next-token loss, and a bias-corrected AdamW step.

    cfg = TransformerConfig()                      # 12 x 768, vocab 32000
    params = init_params(0, cfg)                   # on the card
    opt = init_opt_state(params)
    step = make_train_step(cfg)
    params, opt, loss = step(params, opt, {"tokens": toks}, 0)

The step is out of place: it returns new tensors and never writes its
inputs, so `fault.run_resilient` can keep the old state when it skips a
non-finite step or retries a failed one (the JAX step donates its inputs;
here nothing is donated). Numerics follow the JAX module: RMS norm in
float32 cast back before the scale, tanh GELU, float32 logits before the
log-sum-exp, tied embeddings (the head is `embedding.T`), and attention
through `ops.nn.scaled_dot_product_attention`, the einsum composition the
JAX LM takes on one device. `init_params` draws from a `torch.Generator`
(on the host, so the card and the CPU get the same values), not from
`jax.random`: a deliberate difference; `params_from_jax` takes the JAX
package's values.

Not carried over until the port has a device mesh (ROADMAP A10):
`param_shardings`, ring attention (`use_ring_attention`), the sharded MoE
dispatch, `stack_pipeline_params` and `make_pipeline_train_step`; a
`mesh=` argument raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..device import resolve_device
from ..ops import nn as _nn

__all__ = ["TransformerConfig", "init_params", "forward", "loss_fn",
           "make_train_step", "param_shardings", "TransformerLM",
           "stack_pipeline_params", "make_pipeline_train_step",
           "init_opt_state", "params_from_jax"]


@dataclass
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    use_ring_attention: bool = False  # ring attention over 'sp' (mesh, A10)
    ring_flash: bool = False          # flash kernels per ring hop (A10)
    tie_embeddings: bool = True
    # Mixture-of-experts FFN (0 = dense MLP). On one device every expert
    # runs over every token and top-1 routing selects (the JAX module's
    # dense reference); the expert-parallel dispatch needs a mesh (A10).
    num_experts: int = 0
    ep_axis: str = "dp"
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(cfg):
    return _DTYPES[cfg.dtype]


def _no_mesh(mesh, what):
    if mesh is not None:
        raise MXNetError(f"{what} over a device mesh waits for the port's "
                         f"mesh (ROADMAP A10)")


def init_params(seed, cfg: TransformerConfig, device=None):
    """Initialize the parameter tree (all float32 masters; cast at use),
    drawn from a host `torch.Generator` seeded with `seed`, then placed on
    `device` (default: the current device, the card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size

    def dense_init(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[0]))
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    params = {
        "embedding": dense_init((v, d), scale=0.02),
        "pos_embedding": dense_init((cfg.max_seq_len, d), scale=0.02),
        "final_ln_scale": torch.ones((d,), dtype=torch.float32),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        layer = {
            "ln1_scale": torch.ones((d,), dtype=torch.float32),
            "ln2_scale": torch.ones((d,), dtype=torch.float32),
            "qkv": dense_init((d, 3 * d)),
            "attn_out": dense_init(
                (d, d), scale=1.0 / math.sqrt(d * 2 * cfg.num_layers)),
        }
        out_scale = 1.0 / math.sqrt(f * 2 * cfg.num_layers)
        if cfg.num_experts > 0:
            E = cfg.num_experts
            layer["gate"] = dense_init((d, E), scale=0.02)
            layer["mlp_in"] = torch.stack(
                [dense_init((d, f)) for _ in range(E)])
            layer["mlp_out"] = torch.stack(
                [dense_init((f, d), scale=out_scale) for _ in range(E)])
        else:
            layer["mlp_in"] = dense_init((d, f))
            layer["mlp_out"] = dense_init((f, d), scale=out_scale)
        params["layers"].append(layer)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, v), scale=0.02)
    return _tree_map(lambda t: t.to(dev), params)


def params_from_jax(params_np, device=None):
    """The JAX package's params tree (its leaves as numpy arrays) as the
    port's: the same nested dicts and layer list, each leaf a tensor of the
    same dtype on `device` (default: the current device, the card)."""
    dev = resolve_device(device)
    return _tree_map(
        lambda a: torch.from_numpy(_np.array(a, copy=True)).to(dev),
        params_np)


def param_shardings(cfg: TransformerConfig, mesh):
    """PartitionSpecs over a mesh: waits for the port's mesh (A10)."""
    raise MXNetError("param_shardings places the params over a device "
                     "mesh, which waits for the port's mesh (ROADMAP A10)")


# ---------------------------------------------------------------------------
# the params tree
# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _attention(x, layer, cfg):
    B, T, D = x.shape
    H = cfg.num_heads
    hd = D // H
    qkv = torch.matmul(x, layer["qkv"].to(x.dtype))
    q, k, v = qkv.split(D, dim=-1)
    q = q.reshape(B, T, H, hd).transpose(1, 2)
    k = k.reshape(B, T, H, hd).transpose(1, 2)
    v = v.reshape(B, T, H, hd).transpose(1, 2)
    o = _nn.scaled_dot_product_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(B, T, D)
    return torch.matmul(o, layer["attn_out"].to(x.dtype))


def _mlp(x, layer):
    h = torch.matmul(x, layer["mlp_in"].to(x.dtype))
    h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return torch.matmul(h, layer["mlp_out"].to(x.dtype))


def _moe_mlp_dense(x, layer, cfg):
    """Single-device MoE reference: top-1 routing, no capacity drops.
    Returns (y, aux_loss)."""
    probs = torch.softmax(torch.einsum(
        "btd,de->bte", x.float(), layer["gate"].float()), dim=-1)
    eidx = probs.argmax(-1)                                   # (B, T)
    gate = probs.gather(-1, eidx[..., None])[..., 0]
    # every expert over every token, then select (fine at test scale; the
    # sharded path is the production one)
    h = torch.einsum("btd,edf->betf", x, layer["mlp_in"].to(x.dtype))
    h = F.gelu(h, approximate="tanh")
    y_all = torch.einsum("betf,efd->betd", h, layer["mlp_out"].to(x.dtype))
    E = cfg.num_experts
    onehot = F.one_hot(eidx, E)
    y = torch.einsum("betd,bte->btd", y_all, onehot.to(x.dtype))
    frac_tokens = onehot.float().mean((0, 1))
    frac_probs = probs.mean((0, 1))
    aux = E * (frac_tokens * frac_probs).sum()
    return gate[..., None].to(x.dtype) * y, aux


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            return_aux=False):
    """tokens (B, T) integer tensor -> logits (B, T, V) in the compute
    dtype [, moe aux loss scalar]. A token id outside the vocabulary reads
    the row XLA's gather clamps it to, as in the JAX module."""
    _no_mesh(mesh, "forward")
    dt = _dtype(cfg)
    B, T = tokens.shape
    emb = params["embedding"]
    x = emb.to(dt)[_nn.clamp_index(tokens, emb.shape[0])]
    x = x + params["pos_embedding"].to(dt)[:T][None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        h = _rms_norm(x, layer["ln1_scale"].to(dt))
        x = x + _attention(h, layer, cfg)
        h = _rms_norm(x, layer["ln2_scale"].to(dt))
        if cfg.num_experts > 0:
            y, aux = _moe_mlp_dense(h, layer, cfg)
            aux_total = aux_total + aux.float()
            x = x + y
        else:
            x = x + _mlp(h, layer)
    x = _rms_norm(x, params["final_ln_scale"].to(dt))
    # a cast of its own for the head (as the JAX module): the embedding's
    # two gradients meet in float32, not in the compute dtype
    head = (emb.t() if cfg.tie_embeddings else params["lm_head"]).to(dt)
    logits = torch.matmul(x, head)
    if return_aux:
        return logits, aux_total
    return logits


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy (+ MoE load-balance aux when configured).
    batch: {tokens (B, T+1)}."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg, mesh, return_aux=True)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # an id outside the vocabulary reads NaN, as the JAX package's fill
    # mode gives (a negative one within it counts from the end)
    gold = _nn.take_fill(logits, targets[..., None], -1)[..., 0]
    ce = (logz - gold).mean()
    if cfg.num_experts > 0:
        return ce + cfg.moe_aux_weight * aux
    return ce


def _adamw_update(params, grads, opt_state, t, learning_rate, weight_decay,
                  b1, b2, eps):
    """Bias-corrected AdamW over the params tree, out of place: new params
    and moments, the inputs untouched. `t` is the 1-based step (a Python
    int); the bias corrections are computed in float32 on the host, as the
    JAX module computes `1 - b ** t` in float32."""
    mu, nu = opt_state
    p, m, v = _leaves(params), _leaves(mu), _leaves(nu)
    g = list(grads)
    t32 = _np.float32(t)
    bc1 = float(_np.float32(1) - _np.float32(b1) ** t32)
    bc2 = float(_np.float32(1) - _np.float32(b2) ** t32)
    # m = b1 m + (1 - b1) g; v = b2 v + ((1 - b2) g) g
    m = torch._foreach_mul(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    v = torch._foreach_mul(v, b2)
    torch._foreach_add_(v, gg)
    # p - lr (mhat / (sqrt(vhat) + eps) + wd p)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(upd, torch._foreach_mul(p, weight_decay))
    torch._foreach_mul_(upd, learning_rate)
    new_p = torch._foreach_sub(p, upd)
    return (_unflatten(params, new_p),
            (_unflatten(mu, m), _unflatten(nu, v)))


def make_train_step(cfg: TransformerConfig, mesh=None, learning_rate=3e-4,
                    weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8):
    """Build the AdamW train step: (params, opt_state, batch, step) ->
    (params, opt_state, loss), `step` 0-based (Adam's t is step + 1).

    Out of place: the step differentiates with respect to detached aliases
    of the params and writes every result to new tensors, so its inputs are
    never written (a skipped or retried step goes on from them)."""
    _no_mesh(mesh, "make_train_step")

    def step_fn(params, opt_state, batch, step):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, leaves), batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        new_p, new_opt = _adamw_update(
            params, grads, opt_state, int(step) + 1, learning_rate,
            weight_decay, b1, b2, eps)
        return new_p, new_opt, loss.detach()

    return step_fn


def stack_pipeline_params(params, cfg: TransformerConfig, num_stages):
    """Stage-major stacking for the pipeline step: waits for the port's
    mesh (A10)."""
    raise MXNetError("stack_pipeline_params feeds the pipeline-parallel "
                     "step, which waits for the port's mesh (ROADMAP A10)")


def make_pipeline_train_step(cfg: TransformerConfig, mesh, num_microbatches,
                             learning_rate=3e-4, weight_decay=0.01,
                             b1=0.9, b2=0.95, eps=1e-8):
    """GPipe pipeline-parallel step over a ('pp','dp') mesh: waits for the
    port's mesh (A10)."""
    raise MXNetError("make_pipeline_train_step runs over a device mesh, "
                     "which waits for the port's mesh (ROADMAP A10)")


def init_opt_state(params):
    """AdamW's (mu, nu): zeros like every param, new tensors."""
    return (_tree_map(torch.zeros_like, params),
            _tree_map(torch.zeros_like, params))


class TransformerLM:
    """Object wrapper tying config+params together (gluon-style ergonomics
    over the functional core)."""

    def __init__(self, cfg: TransformerConfig = None, **kwargs):
        self.cfg = cfg or TransformerConfig(**kwargs)
        self.params = None

    def initialize(self, seed=0, device=None):
        self.params = init_params(seed, self.cfg, device)
        return self

    def __call__(self, tokens):
        """Logits of `tokens` (an NDArray or a tensor; the same kind back),
        without a gradient graph."""
        from ..ndarray import NDArray, _wrap
        raw = tokens._t if isinstance(tokens, NDArray) else tokens
        with torch.no_grad():
            out = forward(self.params, raw, self.cfg)
        return _wrap(out) if isinstance(tokens, NDArray) else out
