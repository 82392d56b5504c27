"""Continuous (iteration-level) batching for autoregressive models, in
PyTorch.

Counterpart of `incubator_mxnet_tpu/serve/continuous.py`, same layout and
names:

  * **Slot memory** (`serve.kv_pool.KVCachePool`): a fixed-shape KV slab
    carved once; each admitted request claims a slot ROW; join/leave is
    host bookkeeping.
  * **Step programs**: `prefill` (a windowed causal forward over a padded
    prompt page, KV written into the claimed rows), `chunk_prefill` (one
    window-sized slice of a long prompt, or a prefix-cache hit's suffix,
    at a page offset), `decode` (every pool row advances up to `steps`
    tokens; inactive lanes write into the garbage row) and its
    speculative twin (`draft_tokens > 0`: prompt-lookup drafts verified
    by one forward over the k+1 positions, exact-match acceptance).
    PyTorch runs them eagerly: a "program" is a plain function over
    tensors, and the `steps` loop is a Python loop with no host
    synchronisation inside it.
  * **In-place slab updates**: the programs write K/V (and, on an int8
    pool, codes and their per-position scales) by indexed assignment,
    where the JAX package donates the buffers to a jitted program and
    swaps in its outputs.
  * **Paged attention**: the decode, speculative and chunk attention
    reads go through `ops.fused.paged_attention` — the hand-written CUDA
    kernel (`ops/csrc/paged_attention.cu`, its int8 variant for a
    quantized pool) for tensors on the card, the plain masked-einsum
    version for tensors on the CPU.
  * **Sampling as per-lane data**: temperature / top-k / top-p and a
    request key ride into the programs as (S,) tensors; greedy lanes stay
    exactly argmax. The draw is Gumbel-max with noise from a counter-based
    hash of (request key, position, vocab index), computed with integer
    tensor ops on the lanes' device: a pure function of request state, so
    every wave schedule (and the 1-slot `reference_generate`) draws the
    same tokens. The bits are not `jax.random`'s, so sampled tokens differ
    from the JAX package's; greedy tokens do not.
  * **Shared-prefix cache** (`serve.prefix_cache.PrefixCache`): cached
    prefixes live in dedicated pool rows; a hit copies its row into the
    claimed slot and prefills only the suffix.
  * **Iteration-level scheduling**: every engine iteration retires
    finished requests, admits waiting ones earliest-deadline-first under
    a prefill token budget (billed at their post-cache cost), streams
    long prompts in window-sized chunks, then runs one decode wave over
    every active slot.

The fault points `serve.enqueue` (in `submit`) and `serve.execute` (at
the top of each prefill wave) are the JAX engine's. The knobs resolve as
the JAX package's do: explicit argument > active `mx.tune` profile >
`MXNET_SERVE_*` env > default.

Every step program is memoised per key on its `CachedDecoder` and counts
the argument signatures it has run (`sanitize.counted`):
`compile_cache_size()` is their sum, the zero-retrace observable a
CUDA-graph capture of the programs would have to hold, and the engine
warms every program it will run (prefill, decode with and without the
sampling tensors, every chunk extent, the row copy) before `start()`
returns. Built while an `MXNET_SANITIZE` mode is armed, each program is
also wrapped by `sanitize.maybe_wrap_donated` (the slabs are its in-place
arguments), the engine arms the recompile sentinel after warmup, claims a
canary slot in slot mode, and checks both every decode wave; a violation
fails that wave's requests through the step-failure path, after which the
engine re-poisons the canary, re-arms the sentinel and keeps serving.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as _np
import torch
import torch.nn.functional as F

from .. import fault as _fault
from .. import sanitize as _sanitize
from ..base import MXNetError, get_env, torch_dtype
from ..telemetry import (record_span, trace as _trace, mem_on_oom,
                         mem_install_oom_hook)
from ..ops.nn import clamp_index
from ..device import resolve_device
from ..ops import fused as _fused
from .batcher import (ServeError, QueueFullError, RequestTimeout,
                      ServerClosed, ReplicaDraining, _fail)
from .metrics import SERVE_STATS, _STATS_LOCK, percentile
from .kv_pool import KVCachePool, SlotsFullError
from .prefix_cache import PrefixCache

__all__ = ["DecoderConfig", "CachedDecoder", "ContinuousEngine",
           "init_decoder_params", "params_from_jax"]


# ---------------------------------------------------------------------------
# model: a small cached-KV transformer decoder
# ---------------------------------------------------------------------------
class DecoderConfig:
    """Static shape/config record for `CachedDecoder` (all ints)."""

    def __init__(self, vocab=256, embed=64, layers=2, heads=4,
                 head_dim=16, mlp_hidden=None, max_len=128,
                 dtype="float32"):
        self.vocab = int(vocab)
        self.embed = int(embed)
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.mlp_hidden = int(mlp_hidden if mlp_hidden is not None
                              else 4 * embed)
        self.max_len = int(max_len)
        self.dtype = str(dtype)
        if self.heads * self.head_dim != self.embed:
            raise ServeError(
                f"heads*head_dim ({self.heads}x{self.head_dim}) must "
                f"equal embed ({self.embed})")


_PARAM_NAMES = ("emb", "pos", "wq", "wk", "wv", "wo", "w1", "w2",
                "ln1", "ln2", "lnf")


def init_decoder_params(config, seed=0, device=None):
    """Deterministic random params from a `torch.Generator`, layer-stacked
    on a leading L axis like the JAX package's. The layout and scales are
    the JAX package's; the numbers are not (torch's generator is not
    jax.random) — tests share weights through `params_from_jax`."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = torch_dtype(c.dtype)
    s = 1.0 / _np.sqrt(c.embed)
    m = 1.0 / _np.sqrt(c.mlp_hidden)

    def rnd(shape, scale):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    L, E = c.layers, c.embed
    return {
        "emb": rnd((c.vocab, E), 1.0),
        "pos": rnd((c.max_len, E), 0.1),
        "wq": rnd((L, E, E), s),
        "wk": rnd((L, E, E), s),
        "wv": rnd((L, E, E), s),
        "wo": rnd((L, E, E), s),
        "w1": rnd((L, E, c.mlp_hidden), s),
        "w2": rnd((L, c.mlp_hidden, E), m),
        "ln1": torch.ones((L, E), dtype=dt, device=dev),
        "ln2": torch.ones((L, E), dtype=dt, device=dev),
        "lnf": torch.ones((E,), dtype=dt, device=dev),
    }


def params_from_jax(params_np, device=None):
    """The JAX package's decoder params (`init_decoder_params` there, as
    numpy arrays) as the port's: same names, same layer-stacked layout,
    same dtype, on `device`."""
    if set(params_np) != set(_PARAM_NAMES):
        raise ServeError(f"decoder params must be exactly {_PARAM_NAMES}, "
                         f"got {sorted(params_np)}")
    dev = resolve_device(device)
    out = {}
    for name, a in params_np.items():
        a = _np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":     # ml_dtypes: no from_numpy route
            t = torch.from_numpy(a.view(_np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[name] = t.to(dev)
    return out


def _embed(params, tokens):
    """The token embeddings of `tokens`: an id outside the vocabulary reads
    the row XLA's gather clamps it to, as the JAX package's
    `params["emb"][tokens]` does, so a bad prompt token is served and never
    reaches PyTorch's index kernel (on the card a device-side assert)."""
    emb = params["emb"]
    return emb[clamp_index(tokens, emb.shape[0])]


def _rmsnorm(x, scale):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * scale / torch.sqrt(var + 1e-6)


def _mlp(x, params, l):
    h2 = _rmsnorm(x, params["ln2"][l])
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h2 @ params["w1"][l], approximate="tanh") @ params["w2"][l]


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# sampling as per-lane data
# ---------------------------------------------------------------------------
_MASK32 = 0xFFFFFFFF


def _seed_key(seed):
    """A request seed's key: the uint32 pair `jax.random.PRNGKey(seed)`
    holds (high word, low word), as int64 numpy."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _np.array([(seed >> 32) & _MASK32, seed & _MASK32],
                     dtype=_np.int64)


def _mul32(x, c):
    """(x * c) mod 2^32 for an int64 tensor x in [0, 2^32) and a constant
    c < 2^32, in 16-bit halves so that no product leaves int64."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply, "lowbias32"), a bijection
    on [0, 2^32), over int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel_noise(keys, positions, vocab):
    """Gumbel(0, 1) noise (N, vocab) float32 for N draws: entry (i, v) is a
    pure function of (keys[i], positions[i], v), a counter-based hash
    computed with exact integer ops on the tensors' device, so any wave
    schedule that reaches a (request, position) draws the same noise.
    `keys` (N, 2) int64 (`_seed_key`), `positions` (N,) integer."""
    k = keys.to(torch.int64)
    pos = positions.to(torch.int64) & _MASK32
    lane = _mix32(k[:, 0] ^ _mix32(k[:, 1] ^ _mix32(pos)))          # (N,)
    col = _mix32(torch.arange(vocab, device=keys.device,
                              dtype=torch.int64))                  # (V,)
    bits = _mix32(lane[:, None] ^ col[None, :])
    # 23 bits + 1/2 are exact in f32: u in (0, 1), never 0 or 1
    u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def _sample_tokens(logits, temps, top_ks, top_ps, keys, positions,
                   noise=None):
    """Per-lane next-token choice with the sampling parameters as data,
    the JAX package's rule line for line: scale by the temperature, keep
    the top-k (a descending sort's k-th value), keep the nucleus (the
    exclusive-cumsum prefix whose mass reaches top_p, the crossing token
    included), mask the rest to -1e30, and draw by Gumbel-max. Lanes with
    `temps == 0` return exactly argmax; `temps=None` means every lane is
    greedy. The draw at (lane key, position) is `_gumbel_noise`'s unless
    `noise` (N, vocab) is given (tests feed both packages one noise).

    `logits` (N, V); temps, top_ks, top_ps (N,); keys (N, 2); positions
    (N,) — the query token's cache position. Returns (N,) int32."""
    greedy = _greedy(logits)
    if temps is None:
        return greedy
    V = logits.shape[-1]
    scaled = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    top_ks = top_ks.long()
    kth = srt.gather(1, torch.clamp(top_ks - 1, 0, V - 1)[:, None])
    keep_k = (top_ks[:, None] <= 0) | (scaled >= kth)
    probs = torch.softmax(srt, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keepn = ((csum - probs) < top_ps.float()[:, None]).sum(dim=-1)
    pth = srt.gather(1, torch.clamp(keepn - 1, 0, V - 1)[:, None])
    masked = torch.where(keep_k & (scaled >= pth), scaled,
                         torch.full_like(scaled, -1e30))
    if noise is None:
        noise = _gumbel_noise(keys, positions, V)
    sampled = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _sampling_tensors(temps, top_ks, top_ps, keys, device):
    """Per-lane host sampling arrays (numpy, one entry per lane) as the
    (temps, top_ks, top_ps, keys) tensors the programs take, or four Nones
    when no lane samples (`temps` None or all 0): an all-greedy wave skips
    the sampling math, with the same tokens."""
    if temps is None or not (_np.asarray(temps) > 0).any():
        return None, None, None, None
    return (torch.as_tensor(_np.asarray(temps, _np.float32), device=device),
            torch.as_tensor(_np.asarray(top_ks, _np.int64), device=device),
            torch.as_tensor(_np.asarray(top_ps, _np.float32), device=device),
            torch.as_tensor(_np.asarray(keys, _np.int64), device=device))


def _sample_first(logits, temps, top_ks, top_ps, keys, positions):
    """The first token of each prefill lane from its prompt-tail logits,
    drawn at fold position `positions` (the prompt's last position), from
    host sampling arrays. Returns (N,) int32 numpy."""
    dev = logits.device
    first = _sample_tokens(
        logits, *_sampling_tensors(temps, top_ks, top_ps, keys, dev),
        torch.as_tensor(_np.asarray(positions), device=dev))
    return first.cpu().numpy()


# ---------------------------------------------------------------------------
# KV storage: float slabs, or int8 codes + per-position scales
# ---------------------------------------------------------------------------
def _kv_split(cache):
    """A pool buffer is either a raw slab or a (codes, scales) pair (int8
    mode); normalize to (slab, scales_or_None)."""
    if isinstance(cache, tuple):
        return cache
    return cache, None


def _quantize_kv(val):
    """int8 KV codes + f32 scale per written (lane, position): absmax over
    (heads, head_dim), rounded half to even. The scale is final at write
    time — a position is quantized exactly once, with its KV."""
    a = torch.amax(torch.abs(val), dim=(-2, -1))
    s = torch.clamp(a.float(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(val.float() / s[..., None, None]), -127, 127)
    return q.to(torch.int8), s


def _store_pos(cache, rows, l, wpos, val):
    """Write KV at explicit positions (rows/wpos broadcast to the leading
    dims of `val`), in place, quantizing into codes + scales on an int8
    pool."""
    slab, scales = _kv_split(cache)
    if scales is None:
        slab[:, l][rows, wpos] = val.to(slab.dtype)
        return
    q, s = _quantize_kv(val)
    slab[:, l][rows, wpos] = q
    scales[:, l][rows, wpos] = s


def _store_page(cache, rows, l, W, val):
    """Write a (P, W, H, D) KV page into [rows, l, :W], in place."""
    _store_pos(cache, rows, l, slice(None, W), val)


def _paged_attn(k_cache, v_cache, q, lengths, l, extent=None):
    """Decode-side attention read over the slot slab via
    `ops.fused.paged_attention` (with the scales of an int8 pool). q is
    (S, C, H, D); chunk offset j reads positions [0, lengths + j].

    `extent` cuts the slab's (and scales') position axis to [0, extent)
    as a VIEW (no copy; the kernel reads it through its strides): when
    the caller can bound `lengths + j < extent` for every lane, the
    positions beyond it are masked either way, so the output is the
    full-width read's."""
    k_slab, k_scale = _kv_split(k_cache)
    v_slab, v_scale = _kv_split(v_cache)
    if extent is not None and extent < k_slab.shape[2]:
        k_slab = k_slab[:, :, :extent]
        v_slab = v_slab[:, :, :extent]
        if k_scale is not None:
            k_scale = k_scale[:, :, :extent]
            v_scale = v_scale[:, :, :extent]
    lengths = lengths.to(torch.int32).contiguous()
    return _fused.paged_attention(q.contiguous(), k_slab, v_slab, lengths,
                                  l, k_scale=k_scale, v_scale=v_scale)


def _copy_slot_rows(k_cache, v_cache, src_rows, dst_rows):
    """Whole-row slab-to-slab KV copy, in place — the prefix-cache data
    mover: a cache row into a claimed request slot at admission, a
    retiring request's slot into a cache row at publish. int8 pools copy
    codes AND scales, so a copied position dequantizes bit-identically to
    the original. `src_rows`/`dst_rows` (N,) integer tensors."""
    for cache in (k_cache, v_cache):
        slab, scales = _kv_split(cache)
        slab[dst_rows] = slab[src_rows]
        if scales is not None:
            scales[dst_rows] = scales[src_rows]


# ---------------------------------------------------------------------------
# step programs
# ---------------------------------------------------------------------------
def _make_prefill(config, window=None):
    """Build the prefill step: full causal forward over the padded prompt
    page, KV written into the claimed slot rows, logits at each lane's
    last prompt position.

    `prefill(params, k_cache, v_cache, tokens, lengths, slot_rows) ->
    logits (P, vocab)`; tokens (P, W), lengths and slot_rows (P,). The
    caches are updated in place (quantized on an int8 pool). The in-page
    attention uses the UNQUANTIZED k/v, as the JAX package's does, so a
    prompt's first token does not see the quantization. A lane with no
    request carries slot_row = garbage. Slot positions past the window
    keep the previous tenant's bytes, which the decode mask never
    reaches."""
    c = config
    W = int(window if window is not None else c.max_len)
    if not 1 <= W <= c.max_len:
        raise ServeError(f"prefill window {W} outside [1, {c.max_len}]")
    scale = 1.0 / _np.sqrt(c.head_dim)

    def prefill(params, k_cache, v_cache, tokens, lengths, slot_rows):
        P = tokens.shape[0]
        dev = tokens.device
        lengths = lengths.long()
        x = _embed(params, tokens) + params["pos"][None, :W]
        pos = torch.arange(W, device=dev)
        key_valid = pos[None, :] < lengths[:, None]            # (P, W)
        causal = pos[:, None] >= pos[None, :]                  # (W, W)
        mask = causal[None, None] & key_valid[:, None, None]   # (P,1,W,W)
        rows = slot_rows.long()
        for l in range(c.layers):
            h = _rmsnorm(x, params["ln1"][l])
            q = (h @ params["wq"][l]).reshape(P, W, c.heads, c.head_dim)
            k = (h @ params["wk"][l]).reshape(P, W, c.heads, c.head_dim)
            v = (h @ params["wv"][l]).reshape(P, W, c.heads, c.head_dim)
            _store_page(k_cache, rows, l, W, k)
            _store_page(v_cache, rows, l, W, v)
            scores = torch.einsum("pqhd,pkhd->phqk", q, k) * scale
            # -1e30, or float16's lowest (the JAX package's -1e30 rounds
            # to -inf there; either gives exp() = 0)
            scores = scores.masked_fill(
                ~mask, max(-1e30, torch.finfo(scores.dtype).min))
            att = torch.einsum("phqk,pkhd->pqhd",
                               torch.softmax(scores, dim=-1), v)
            x = x + att.reshape(P, W, c.embed) @ params["wo"][l]
            x = x + _mlp(x, params, l)
        xf = _rmsnorm(x, params["lnf"])
        last = xf[torch.arange(P, device=dev),
                  torch.clamp(lengths - 1, min=0)]             # (P, E)
        return last @ params["emb"].T

    return prefill


def _make_chunk_prefill(config, window=None, extent=None):
    """Build the CHUNK prefill step: one window-sized slice of a prompt,
    written into its slot page at an arbitrary offset, with a paged
    attention read clamped to `[0, offset + j]`. This is how prompts
    longer than `prefill_window` stream in across waves, and how a
    prefix-cache hit prefills only its suffix.

    `chunk_prefill(params, k_cache, v_cache, tokens, offsets, nvalid) ->
    logits (S, vocab)`; tokens (S, W), offsets and nvalid (S,). Lanes are
    POOL ROWS (lane s writes row s); a lane with `nvalid == 0` writes into
    the garbage row. Positions below `offsets` must already hold the
    prefix KV (earlier chunks, or a prefix-cache row copy); on an int8
    pool the read dequantizes them and the positions this chunk has just
    written. Logits come from each lane's last valid chunk position.
    `extent` bounds the attention read to slab positions [0, extent):
    valid for a wave whose furthest lane satisfies offset + nvalid <=
    extent."""
    c = config
    W = int(window if window is not None else c.max_len)
    if not 1 <= W <= c.max_len:
        raise ServeError(f"chunk window {W} outside [1, {c.max_len}]")
    E = int(extent if extent is not None else c.max_len)
    if not W <= E <= c.max_len:
        raise ServeError(
            f"chunk extent {E} outside [window={W}, {c.max_len}]")

    def chunk_prefill(params, k_cache, v_cache, tokens, offsets, nvalid):
        S = tokens.shape[0]
        T = c.max_len
        dev = tokens.device
        j = torch.arange(W, device=dev)
        lanes = torch.arange(S, device=dev)
        offsets = offsets.long()
        wposs = torch.clamp(offsets[:, None] + j[None, :], 0, T - 1)
        valid = j[None, :] < nvalid.long()[:, None]            # (S, W)
        rows = torch.where(valid, lanes[:, None], S)           # garbage=S
        x = _embed(params, tokens) + params["pos"][wposs]
        for l in range(c.layers):
            h = _rmsnorm(x, params["ln1"][l])
            q = (h @ params["wq"][l]).reshape(S, W, c.heads, c.head_dim)
            k = (h @ params["wk"][l]).reshape(S, W, c.heads, c.head_dim)
            v = (h @ params["wv"][l]).reshape(S, W, c.heads, c.head_dim)
            _store_pos(k_cache, rows, l, wposs, k)
            _store_pos(v_cache, rows, l, wposs, v)
            att = _paged_attn(k_cache, v_cache, q, offsets, l, extent=E)
            x = x + att.reshape(S, W, c.embed) @ params["wo"][l]
            x = x + _mlp(x, params, l)
        xf = _rmsnorm(x, params["lnf"])
        last = xf[lanes, torch.clamp(nvalid.long() - 1, min=0)]
        return last @ params["emb"].T

    return chunk_prefill


def _make_decode(config, steps=1, eos_id=None):
    """Build the decode step: EVERY pool slot advances up to `steps`
    tokens. Lanes with `steps_left == 0` are inactive and write into the
    garbage row; the step count is fixed, so a lane finishing mid-wave
    only idles.

    `decode(params, k_cache, v_cache, tokens, lengths, steps_left,
    temps=None, top_ks=None, top_ps=None, keys=None) -> (out_tokens
    (steps, S) int32, emitted (S,) int32)`. The sampling data are (S,)
    tensors (keys (S, 2)); `temps=None` is an all-greedy wave. `emitted[s]`
    is the exact number of tokens lane s produced this wave (rows
    [0:emitted] of its column), counted in the loop because `eos_id`
    zeroes a lane's remaining budget mid-wave. The caches are updated in
    place, and nothing in the loop waits for the device."""
    c = config

    def micro(params, k_cache, v_cache, tokens, lengths, active, sampling):
        # one token for every active lane; the new token's KV lands at
        # position `lengths`, and attention reads 0..lengths inclusive
        S = tokens.shape[0]
        T = c.max_len
        dev = tokens.device
        rows = torch.where(active, torch.arange(S, device=dev), S)
        wpos = torch.clamp(lengths, 0, T - 1).long()
        x = _embed(params, tokens) + params["pos"][wpos]   # (S, E)
        for l in range(c.layers):
            h = _rmsnorm(x, params["ln1"][l])
            q = (h @ params["wq"][l]).reshape(S, c.heads, c.head_dim)
            k = (h @ params["wk"][l]).reshape(S, c.heads, c.head_dim)
            v = (h @ params["wv"][l]).reshape(S, c.heads, c.head_dim)
            _store_pos(k_cache, rows, l, wpos, k)
            _store_pos(v_cache, rows, l, wpos, v)
            att = _paged_attn(k_cache, v_cache, q[:, None], lengths,
                              l)[:, 0]
            x = x + att.reshape(S, c.embed) @ params["wo"][l]
            x = x + _mlp(x, params, l)
        logits = _rmsnorm(x, params["lnf"]) @ params["emb"].T
        nxt = _sample_tokens(logits, *sampling, lengths)
        return torch.where(active, nxt, 0)

    def decode(params, k_cache, v_cache, tokens, lengths, steps_left,
               temps=None, top_ks=None, top_ps=None, keys=None):
        sampling = (temps, top_ks, top_ps, keys)
        last = tokens.to(torch.int32)
        lens = lengths.to(torch.int32)
        left = steps_left.to(torch.int32)
        emitted = torch.zeros_like(left)
        out = []
        for _ in range(steps):
            act = left > 0
            nxt = micro(params, k_cache, v_cache, last, lens, act, sampling)
            new_left = torch.where(act, left - 1, left)
            if eos_id is not None:
                new_left = torch.where(act & (nxt == eos_id), 0, new_left)
            lens = torch.where(act, lens + 1, lens)
            last = torch.where(act, nxt, last)
            emitted = emitted + act.to(torch.int32)
            left = new_left
            out.append(nxt)
        return torch.stack(out), emitted

    return decode


def _make_spec_decode(config, steps=1, eos_id=None, draft=2):
    """Build the SPECULATIVE decode step: each of the `steps` micro-steps
    advances every active lane by up to `draft + 1` tokens — k drafted by
    prompt-lookup (the latest earlier occurrence of the lane's tail token
    in its token page predicts its historical successors) plus one bonus
    token, verified by ONE forward over the k+1 positions through the
    paged attention (C = k+1 queries). Acceptance is EXACT match against
    the base model's own choice at each position (drawn with that
    position's key), so the emitted stream is token-identical to
    non-speculative decode, greedy and sampled.

    Safety of the chunk writes:
      * a REJECTED position's KV is stale, but the lane's next chunk
        starts at its new length and rewrites [len, len+k] before any
        mask can expose it;
      * near the page end, write positions clip to max_len-1 and may
        repeat within one indexed assignment, where on CUDA the winning
        writer is undefined (codes and scales possibly from different
        writers). Only queries whose outputs are DISCARDED (offset >=
        emitted count) ever sit past max_len-2, and a query reads only
        positions <= its own, so the clipped junk is unreachable from any
        emitted token.

    `spec(params, k_cache, v_cache, tokens, lengths, steps_left, temps,
    top_ks, top_ps, keys, token_buf) -> (tok_blocks (steps, S, draft+1),
    n_emits (steps, S), emitted (S,), accepted (S,), rejected (S,))`.
    `token_buf` is the (S, max_len) token history page (prompt + generated
    so far; entries [0, lengths] valid), the draft source, updated in the
    loop exactly as a host rebuild would be. Lane s's wave output is
    `tok_blocks[i, s, :n_emits[i, s]]` in step order; accepted/rejected
    count draft tokens. `temps=None` is an all-greedy wave. Nothing in the
    loop waits for the device."""
    c = config
    draft = int(draft)
    if draft < 1:
        raise ServeError(f"draft must be >= 1, got {draft}")
    C = draft + 1

    def micro(params, k_cache, v_cache, last, lens, act, left, sampling,
              token_buf):
        S = last.shape[0]
        T = c.max_len
        dev = last.device
        lanes = torch.arange(S, device=dev)
        rows = torch.where(act, lanes, S)                  # garbage row
        coffs = torch.arange(C, device=dev)
        lens64 = lens.long()
        # -- prompt-lookup draft: the LATEST earlier occurrence of the
        # current tail token predicts its historical successors
        idx = torch.arange(T, device=dev)
        hit = (idx[None, :] < lens64[:, None]) & (token_buf == last[:, None])
        p = torch.amax(torch.where(hit, idx[None, :], -1), dim=1)  # (S,)
        dsrc = p[:, None] + 1 + torch.arange(draft, device=dev)[None, :]
        ok = (p[:, None] >= 0) & (dsrc <= lens64[:, None])
        cand = torch.gather(token_buf, 1, torch.clamp(dsrc, 0, T - 1))
        drafts = torch.where(ok, cand, last[:, None])            # (S, k)
        # -- ONE verify forward over the whole chunk [last, drafts...]
        chunk = torch.cat([last[:, None], drafts], dim=1)         # (S, C)
        wposs = torch.clamp(lens64[:, None] + coffs[None, :], 0, T - 1)
        x = _embed(params, chunk) + params["pos"][wposs]    # (S,C,E)
        for l in range(c.layers):
            h = _rmsnorm(x, params["ln1"][l])
            q = (h @ params["wq"][l]).reshape(S, C, c.heads, c.head_dim)
            k = (h @ params["wk"][l]).reshape(S, C, c.heads, c.head_dim)
            v = (h @ params["wv"][l]).reshape(S, C, c.heads, c.head_dim)
            _store_pos(k_cache, rows[:, None], l, wposs, k)
            _store_pos(v_cache, rows[:, None], l, wposs, v)
            att = _paged_attn(k_cache, v_cache, q, lens, l)
            x = x + att.reshape(S, C, c.embed) @ params["wo"][l]
            x = x + _mlp(x, params, l)
        logits = _rmsnorm(x, params["lnf"]) @ params["emb"].T     # (S,C,V)
        # -- the base model's own choice at EVERY chunk position, keyed by
        # that position: the draws of non-speculative decode
        positions = (lens64[:, None] + coffs[None, :]).reshape(-1)
        temps, top_ks, top_ps, keys = sampling
        if temps is not None:
            temps, top_ks, top_ps, keys = (
                t.repeat_interleave(C, dim=0)
                for t in (temps, top_ks, top_ps, keys))
        base_next = _sample_tokens(
            logits.reshape(S * C, -1), temps, top_ks, top_ps, keys,
            positions).reshape(S, C)
        # -- accept the longest draft prefix the base model agrees with,
        # plus the bonus token after it; cap to the lane budget
        match = torch.cumprod(
            (drafts == base_next[:, :draft]).to(torch.int32), dim=1)
        n = torch.minimum(match.sum(dim=1, dtype=torch.int32) + 1, left)
        if eos_id is not None:
            is_eos = (base_next == eos_id) & (coffs[None, :] < n[:, None])
            n = torch.where(is_eos.any(dim=1),
                            torch.argmax(is_eos.to(torch.int32), dim=1)
                            .to(torch.int32) + 1, n)
        n = torch.where(act, n, 0)
        tail = torch.gather(base_next, 1,
                            torch.clamp(n - 1, min=0).long()[:, None])[:, 0]
        new_last = torch.where(act, tail, last)
        new_lens = lens + n
        # -- history page update, what a host rebuild would hold: the chunk
        # token at each written position, the new tail at new_lens
        buf2 = token_buf.clone()
        buf2[lanes[:, None], wposs] = torch.cat(
            [last[:, None], base_next[:, :draft]], dim=1)
        buf2[lanes, torch.clamp(new_lens, 0, T - 1).long()] = new_last
        token_buf = torch.where(act[:, None], buf2, token_buf)
        return token_buf, base_next, n, new_last, new_lens

    def spec(params, k_cache, v_cache, tokens, lengths, steps_left, temps,
             top_ks, top_ps, keys, token_buf):
        sampling = (temps, top_ks, top_ps, keys)
        last = tokens.to(torch.int32)
        lens = lengths.to(torch.int32)
        left = steps_left.to(torch.int32)
        buf = token_buf.to(torch.int32)
        emitted = torch.zeros_like(left)
        acc = torch.zeros_like(left)
        rej = torch.zeros_like(left)
        blocks, n_emits = [], []
        for _ in range(steps):
            act = left > 0
            buf, base_next, n, last, lens = micro(
                params, k_cache, v_cache, last, lens, act, left, sampling,
                buf)
            left = torch.where(act, left - n, left)
            if eos_id is not None:
                left = torch.where(act & (n > 0) & (last == eos_id), 0,
                                   left)
            emitted = emitted + n
            acc = acc + torch.where(act, n - 1, 0)
            rej = rej + torch.where(act, draft - (n - 1), 0)
            blocks.append(base_next)
            n_emits.append(n)
        return (torch.stack(blocks), torch.stack(n_emits), emitted, acc,
                rej)

    return spec


class CachedDecoder:
    """The model side of the continuous engine: the step programs over a
    KV slot pool, on one device (`cuda` unless the caller passes
    `device="cpu"`).

    `params=` shares weights across instances (e.g. `params_from_jax`
    output, or a reference decoder for tests); `seed=` controls the
    deterministic random init otherwise.
    """

    def __init__(self, config, params=None, seed=0, device=None):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = init_decoder_params(config, seed, self.device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        # the step programs, memoised per key as the JAX package memoises
        # its jits
        self._prefills = {}
        self._chunks = {}
        self._decodes = {}
        self._copy = None

    def new_pool(self, max_slots=None, dtype=None):
        """A slot pool at this model's shape; `dtype` is the KV storage
        dtype (the model's by default; another float dtype, or "int8")."""
        c = self.config
        return KVCachePool(max_slots, layers=c.layers, max_len=c.max_len,
                           heads=c.heads, head_dim=c.head_dim,
                           dtype=dtype or c.dtype, device=self.device)

    @staticmethod
    def _program(fn, key, donated, name):
        """`fn` with its signature count, wrapped by the sanitizer when a
        mode is armed (the `donated` positions are updated in place)."""
        return _sanitize.maybe_wrap_donated(_sanitize.counted(fn, key),
                                            donated, name)

    def prefill_program(self, window):
        """The prefill program for a prompt-page width (memoised)."""
        key = int(window)
        fn = self._prefills.get(key)
        if fn is None:
            fn = self._program(_make_prefill(self.config, window=key), key,
                               (1, 2), f"prefill[w={key}]")
            self._prefills[key] = fn
        return fn

    def chunk_prefill_program(self, window, extent=None):
        """The CHUNK prefill program for a (window, extent) pair
        (memoised)."""
        key = (int(window),
               int(extent if extent is not None else self.config.max_len))
        fn = self._chunks.get(key)
        if fn is None:
            fn = self._program(
                _make_chunk_prefill(self.config, window=key[0],
                                    extent=key[1]),
                key, (1, 2), f"chunk_prefill[w={key[0]},e={key[1]}]")
            self._chunks[key] = fn
        return fn

    def decode_program(self, steps, eos_id=None, draft=0):
        """The decode program for a (steps, eos, draft) variant (memoised);
        `draft > 0` selects the speculative program."""
        key = (int(steps), eos_id, int(draft))
        fn = self._decodes.get(key)
        if fn is None:
            if key[2] > 0:
                built = _make_spec_decode(self.config, steps=key[0],
                                          eos_id=eos_id, draft=key[2])
            else:
                built = _make_decode(self.config, steps=key[0],
                                     eos_id=eos_id)
            fn = self._program(built, key, (1, 2),
                               f"decode[s={key[0]},eos={key[1]},"
                               f"d={key[2]}]")
            self._decodes[key] = fn
        return fn

    def copy_program(self):
        """The slab-to-slab KV row copy (prefix-cache hit and publish):
        `copy(k_cache, v_cache, src_rows, dst_rows)`, in place
        (memoised)."""
        if self._copy is None:
            self._copy = self._program(_copy_slot_rows, "copy", (0, 1),
                                       "copy_slot_rows")
        return self._copy

    def compile_cache_size(self):
        """Distinct argument signatures run across every program — the
        zero-retrace observable (one entry per program variant a CUDA-graph
        capture would hold)."""
        fns = (list(self._prefills.values()) + list(self._chunks.values())
               + list(self._decodes.values()))
        if self._copy is not None:
            fns.append(self._copy)
        return sum(int(f._cache_size()) for f in fns)

    def _ints(self, a):
        return torch.as_tensor(_np.asarray(a, dtype=_np.int32),
                               device=self.device)

    def prefill(self, k_cache, v_cache, tokens, lengths, slot_rows,
                temps=None, top_ks=None, top_ps=None, keys=None):
        """Prefill (window = the token page width) and return each lane's
        first token, (P,) int32 numpy, drawn at position lengths - 1 (the
        sampling arrays are host numpy; None = greedy)."""
        logits = self.prefill_program(tokens.shape[1])(
            self.params, k_cache, v_cache, tokens, lengths, slot_rows)
        return _sample_first(logits, temps, top_ks, top_ps, keys,
                             lengths.cpu().numpy() - 1)

    def decode(self, k_cache, v_cache, tokens, lengths, steps_left,
               steps=1, eos_id=None, temps=None, top_ks=None, top_ps=None,
               keys=None, draft=0, token_buf=None):
        """One decode wave. The sampling arrays are host numpy (None =
        greedy). Returns `(out_tokens (steps, S), emitted (S,))`, or with
        `draft > 0` (which needs `token_buf`, the (S, max_len) history
        page) `(tok_blocks, n_emits, emitted, accepted, rejected)`."""
        prog = self.decode_program(steps, eos_id, draft)
        sampling = _sampling_tensors(temps, top_ks, top_ps, keys,
                                     self.device)
        if int(draft) > 0:
            if token_buf is None:
                raise ServeError(
                    "speculative decode (draft > 0) needs token_buf — "
                    "the (S, max_len) prompt+generated history page")
            return prog(self.params, k_cache, v_cache, tokens, lengths,
                        steps_left, *sampling, token_buf)
        return prog(self.params, k_cache, v_cache, tokens, lengths,
                    steps_left, *sampling)

    def reference_generate(self, prompt, max_new_tokens, eos_id=None,
                           window=None, temperature=0.0, top_k=0,
                           top_p=1.0, seed=0, draft_tokens=0,
                           kv_dtype=None, cached_prefix_len=0):
        """Generation through a PRIVATE 1-slot pool — the scheduling-free
        reference the engine's mixed-batch outputs must match
        token-for-token. Pass the engine's `prefill_window`: prompts
        longer than the window replay the engine's CHUNKED prefill (a
        windowed first chunk at offset 0, then window-sized slices through
        the chunk program). `cached_prefix_len=L` mirrors a prefix-cache
        HIT: positions [0, L) are built the cold way (windowed head +
        chunks, which is what a published cache row holds) and the suffix
        [L, plen) goes through the chunk program, as the engine prefills
        it after the row copy. Sampling (`temperature > 0` with the
        request `seed`) matches the engine because the draw is a pure
        function of (seed, position); `draft_tokens > 0` runs the
        speculative program one wave at a time with a host-rebuilt history
        page; `kv_dtype` is the pool's storage dtype (the engine's
        `kv_dtype`, e.g. "int8")."""
        c = self.config
        pool = self.new_pool(max_slots=1, dtype=kv_dtype)
        k, v = pool.buffers()
        W = int(window if window is not None else c.max_len)
        prompt = _np.asarray(prompt, dtype=_np.int32).ravel()
        plen = int(prompt.size)
        if plen < 1 or plen >= c.max_len:
            raise ServeError(
                f"prompt length {plen} outside [1, max_len-1="
                f"{c.max_len - 1}]")
        L = int(cached_prefix_len)
        if not 0 <= L < plen:
            raise ServeError(
                f"cached_prefix_len {L} outside [0, plen-1={plen - 1}]")
        temps = _np.asarray([float(temperature)], _np.float32)
        tks = _np.asarray([int(top_k)], _np.int64)
        tps = _np.asarray([float(top_p)], _np.float32)
        keys = _seed_key(seed)[None, :]
        # windowed head: a cold request's offset-0 wave covers
        # min(plen, W) tokens; a hit's head stops at the cache boundary
        head = min(plen if L == 0 else L, W)
        toks = _np.zeros((1, W), dtype=_np.int32)
        toks[0, :head] = prompt[:head]
        logits = self.prefill_program(W)(
            self.params, k, v, self._ints(toks), self._ints([head]),
            self._ints([0]))
        pos = head
        chunk = self.chunk_prefill_program(W) if head < plen else None
        while pos < plen:
            n = min(W, plen - pos)
            ctoks = _np.zeros((1, W), dtype=_np.int32)
            ctoks[0, :n] = prompt[pos:pos + n]
            logits = chunk(self.params, k, v, self._ints(ctoks),
                           self._ints([pos]), self._ints([n]))
            pos += n
        out = [int(_sample_first(logits, temps, tks, tps, keys,
                                 [plen - 1])[0])]
        cache_len = plen
        draft = int(draft_tokens)
        while (len(out) < max_new_tokens
               and (eos_id is None or out[-1] != eos_id)
               and cache_len + 1 < c.max_len):
            if draft > 0:
                left = min(max_new_tokens - len(out),
                           c.max_len - 1 - cache_len)
                buf = _np.zeros((1, c.max_len), dtype=_np.int32)
                hist = list(prompt) + out
                buf[0, :len(hist)] = hist
                blocks, n_emits, _, _, _ = self.decode(
                    k, v, self._ints([out[-1]]), self._ints([cache_len]),
                    self._ints([left]), steps=1, eos_id=eos_id,
                    temps=temps, top_ks=tks, top_ps=tps, keys=keys,
                    draft=draft, token_buf=self._ints(buf))
                n = int(n_emits[0, 0])
                out.extend(int(t) for t in blocks[0, 0, :n].tolist())
                cache_len += n
            else:
                toks1, _ = self.decode(
                    k, v, self._ints([out[-1]]), self._ints([cache_len]),
                    self._ints([1]), temps=temps, top_ks=tks, top_ps=tps,
                    keys=keys)
                out.append(int(toks1[0, 0]))
                cache_len += 1
        return _np.asarray(out, dtype=_np.int32)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class _GenRequest:
    __slots__ = ("prompt", "max_new", "future", "deadline", "t_submit",
                 "slot", "generated", "cache_len", "t_first", "t_last",
                 "temperature", "top_k", "top_p", "key", "entry",
                 "cached_len", "prefill_pos", "ctx")

    def __init__(self, prompt, max_new, deadline, temperature=0.0, top_k=0,
                 top_p=1.0, key=None, ctx=None):
        self.prompt = prompt                 # np.int32 (plen,)
        self.ctx = ctx                       # serve.request root context
        self.max_new = max_new
        self.future = Future()
        self.deadline = deadline             # perf_counter deadline or None
        self.t_submit = time.perf_counter()
        self.slot = None
        self.generated = []
        self.cache_len = 0
        self.t_first = None                  # first token (TTFT anchor)
        self.t_last = None
        self.temperature = temperature       # 0.0 = greedy lane
        self.top_k = top_k
        self.top_p = top_p
        self.key = key if key is not None else _seed_key(0)
        self.entry = None        # pinned prefix-cache entry (hit path)
        self.cached_len = 0      # prompt tokens served from the cache
        self.prefill_pos = 0     # prompt tokens already in KV (chunked)

    def sort_key(self):
        """Earliest-deadline-first; deadline-less requests rank after
        every deadline-holder, FIFO among themselves."""
        return (self.deadline is None,
                self.deadline if self.deadline is not None
                else self.t_submit,
                self.t_submit)


class _LaneSampling:
    """Per-lane sampling arrays of one wave (greedy defaults), filled from
    requests and handed to the programs as device tensors."""

    def __init__(self, n):
        self.temps = _np.zeros((n,), dtype=_np.float32)
        self.top_ks = _np.zeros((n,), dtype=_np.int64)
        self.top_ps = _np.ones((n,), dtype=_np.float32)
        self.keys = _np.zeros((n, 2), dtype=_np.int64)

    def set(self, i, req):
        self.temps[i] = req.temperature
        self.top_ks[i] = req.top_k
        self.top_ps[i] = req.top_p
        self.keys[i] = req.key

    def host(self):
        return self.temps, self.top_ks, self.top_ps, self.keys


class ContinuousEngine:
    """Iteration-level batching decode engine over a `CachedDecoder`.

    ::

        model = serve.CachedDecoder(serve.DecoderConfig(max_len=64))
        with serve.ContinuousEngine(model, max_slots=8) as eng:
            fut = eng.submit([3, 14, 15], max_new_tokens=16)
            tokens = fut.result()            # np.int32 generated ids

    Knobs (constructor arg > active `mx.tune` profile > MXNET_SERVE_* env
    > default, the JAX package's names and order):

      max_slots        KV slots = max concurrently-decoding requests
                       (MXNET_SERVE_MAX_SLOTS, 8)
      prefill_budget   max prompt TOKENS prefilled per engine iteration
                       (MXNET_SERVE_PREFILL_BUDGET, 256); >= 1 request is
                       always admitted when a slot is free
      prefill_lanes    lane count of the prefill program
                       (MXNET_SERVE_PREFILL_LANES, min(max_slots, 8))
      prefill_window   prompt page width (default max_len); longer
                       prompts stream in window-sized chunks
      decode_steps     micro-steps per decode wave
                       (MXNET_SERVE_DECODE_STEPS, 4)
      max_queue        waiting-request bound, reject-newest
                       (MXNET_SERVE_MAX_QUEUE, 256)
      default_deadline_ms  queue deadline (MXNET_SERVE_DEADLINE_MS);
                       expiry while WAITING fails fast with RequestTimeout
      eos_id           token that ends a request
      draft_tokens     speculative decode depth k
                       (MXNET_SERVE_DRAFT_TOKENS, 0 = off): each
                       micro-step drafts k tokens by prompt-lookup and
                       verifies them in one forward; output tokens are
                       IDENTICAL to draft_tokens=0
      kv_dtype         KV pool storage dtype (MXNET_SERVE_KV_DTYPE; the
                       model's by default): another float dtype, or
                       "int8" (codes + per-position f32 scales, see
                       pool.stats()["slots_per_gb"])
      prefix_cache_slots  dedicated pool rows holding shared-prefix KV
                       (MXNET_SERVE_PREFIX_CACHE_SLOTS, 0 = off):
                       admission matches the longest cached prefix,
                       row-copies its KV into the claimed slot, and
                       prefills ONLY the suffix
      prefix_block     prefix-cache granularity in tokens
                       (MXNET_SERVE_PREFIX_BLOCK, 16)
      prefix_cache_insert  publish a retiring request's own prompt
                       prefix into the cache
                       (MXNET_SERVE_PREFIX_CACHE_INSERT, 1)

    Exactly one scheduler thread runs the step programs, so the KV slabs
    have a single writer; submit() is safe from any thread.
    """

    def __init__(self, model, *, max_slots=None, prefill_budget=None,
                 prefill_lanes=None, prefill_window=None, decode_steps=None,
                 max_queue=None, default_deadline_ms=None, eos_id=None,
                 draft_tokens=None, kv_dtype=None, prefix_block=None,
                 prefix_cache_slots=None, prefix_cache_insert=None,
                 name="serve.continuous"):
        self.model = model
        self.name = name
        self.eos_id = eos_id
        self.device = model.device
        # the profile tier loads lazily, as in the JAX package
        from ..tune.profile import resolve as _tune_resolve
        if max_slots is None:
            max_slots = _tune_resolve("serve.max_slots")
        if kv_dtype is None:
            kv_dtype = _tune_resolve("serve.kv_dtype")
            if kv_dtype is None:
                kv_dtype = get_env("MXNET_SERVE_KV_DTYPE")
        self.kv_dtype = kv_dtype
        if prefix_block is None:
            prefix_block = _tune_resolve("serve.prefix_block")
            if prefix_block is None:
                prefix_block = get_env("MXNET_SERVE_PREFIX_BLOCK", 16,
                                       typ=int)
        self.prefix_block = int(prefix_block)
        if self.prefix_block < 1:
            raise ServeError("prefix_block must be >= 1")
        if prefix_cache_slots is None:
            prefix_cache_slots = _tune_resolve("serve.prefix_cache_slots")
            if prefix_cache_slots is None:
                prefix_cache_slots = get_env(
                    "MXNET_SERVE_PREFIX_CACHE_SLOTS", 0, typ=int)
        self.prefix_cache_slots = int(prefix_cache_slots)
        if self.prefix_cache_slots < 0:
            raise ServeError("prefix_cache_slots must be >= 0")
        if prefix_cache_insert is None:
            prefix_cache_insert = _tune_resolve(
                "serve.prefix_cache_insert")
            if prefix_cache_insert is None:
                prefix_cache_insert = bool(get_env(
                    "MXNET_SERVE_PREFIX_CACHE_INSERT", 1, typ=int))
        self.prefix_cache_insert = bool(prefix_cache_insert)
        if max_slots is None:
            max_slots = get_env("MXNET_SERVE_MAX_SLOTS", 8, typ=int)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ServeError("max_slots must be >= 1")
        # max_slots REQUEST rows plus the dedicated prefix-cache rows;
        # self.max_slots stays the request capacity admission sees
        self.pool = model.new_pool(
            self.max_slots + self.prefix_cache_slots, dtype=kv_dtype)
        self._cache = None
        if self.prefix_cache_slots:
            self._cache = PrefixCache(
                self.prefix_block,
                [self.pool.claim() for _ in range(self.prefix_cache_slots)])
        if decode_steps is None:
            decode_steps = _tune_resolve("serve.decode_steps")
            if decode_steps is None:
                decode_steps = get_env("MXNET_SERVE_DECODE_STEPS", 4,
                                       typ=int)
        self.decode_steps = max(1, int(decode_steps))
        if draft_tokens is None:
            draft_tokens = _tune_resolve("serve.draft_tokens")
        self.draft_tokens = int(
            draft_tokens if draft_tokens is not None
            else get_env("MXNET_SERVE_DRAFT_TOKENS", 0, typ=int))
        if self.draft_tokens < 0:
            raise ServeError("draft_tokens must be >= 0")
        self._decode_prog = model.decode_program(
            self.decode_steps, eos_id, self.draft_tokens)
        self.prefill_window = int(
            prefill_window if prefill_window is not None
            else model.config.max_len)
        if not 1 <= self.prefill_window <= model.config.max_len:
            raise ServeError(
                f"prefill_window must be in [1, max_len], got "
                f"{self.prefill_window}")
        self._prefill_prog = model.prefill_program(self.prefill_window)
        # chunk programs exist when a prompt can outgrow the window or a
        # cache hit leaves a suffix at a nonzero offset. They form an
        # EXTENT LADDER (window, 2*window, ... max_len): a wave's
        # attention read covers how far its furthest lane has streamed,
        # not max_len
        self._chunk_progs = None
        self._chunk_extents = ()
        if (self.prefill_window < model.config.max_len
                or self._cache is not None):
            exts, e = [], self.prefill_window
            while e < model.config.max_len:
                exts.append(e)
                e *= 2
            exts.append(model.config.max_len)
            self._chunk_extents = tuple(exts)
            self._chunk_progs = {
                x: model.chunk_prefill_program(self.prefill_window,
                                               extent=x)
                for x in exts}
        self._copy_prog = (model.copy_program()
                           if self._cache is not None else None)
        self.prefill_budget = int(
            prefill_budget if prefill_budget is not None
            else get_env("MXNET_SERVE_PREFILL_BUDGET", 256, typ=int))
        if self.prefill_budget < 1:
            raise ServeError("prefill_budget must be >= 1")
        if prefill_lanes is None:
            prefill_lanes = _tune_resolve("serve.prefill_lanes")
            if prefill_lanes is None:
                prefill_lanes = get_env("MXNET_SERVE_PREFILL_LANES",
                                        typ=int)
        self.prefill_lanes = int(prefill_lanes if prefill_lanes is not None
                                 else min(self.max_slots, 8))
        if not 1 <= self.prefill_lanes <= self.max_slots:
            raise ServeError(
                f"prefill_lanes must be in [1, max_slots], got "
                f"{self.prefill_lanes}")
        self.max_queue = int(
            max_queue if max_queue is not None
            else get_env("MXNET_SERVE_MAX_QUEUE", 256, typ=int))
        dl = (default_deadline_ms if default_deadline_ms is not None
              else get_env("MXNET_SERVE_DEADLINE_MS", typ=float))
        self.default_deadline_s = None if dl is None else float(dl) / 1e3
        self.max_len = model.config.max_len

        self._cv = threading.Condition()
        self._waiting = deque()              # submitted, no slot yet
        self._prefilling = {}                # slot -> req, prompt KV partial
        self._running = {}                   # slot -> _GenRequest
        self._closing = False
        self._drain = True
        self._started = False
        self._warm_cache_size = None
        self._canary = None
        self.warmup_s = None
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-scheduler", daemon=True)

        # per-engine metrics (all mutation under _mlock)
        self._mlock = threading.Lock()
        self._t0 = time.perf_counter()
        self._counters = {k: 0 for k in (
            "requests", "replies", "rejected", "timeouts", "errors",
            "admitted", "retired", "decode_iterations", "decode_tokens",
            "prefill_tokens", "prefill_batches", "chunk_batches",
            "active_sum", "sampled_tokens", "draft_accepted",
            "draft_rejected", "prefix_hits", "prefix_misses",
            "prefix_cached_tokens")}
        self._auto_seed = 0                  # per-engine seed fountain
        self._ttft_ms = deque(maxlen=4096)
        self._tpot_ms = deque(maxlen=4096)
        self._e2e_ms = deque(maxlen=4096)

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup=True):
        """Run one garbage-lane pass through every step program the engine
        will run (this builds the CUDA kernels at first use and
        initialises the matrix-product libraries, so the first request
        does not pay for either), record the warm signature count for the
        zero-retrace assertion, arm the sanitizer's modes, then start the
        scheduler thread. Returns self."""
        if self._started:
            return self
        t0 = time.perf_counter()
        if warmup:
            self._warmup()
        with self._cv:
            self._warm_cache_size = self.model.compile_cache_size()
            self._started = True
        self.warmup_s = round(time.perf_counter() - t0, 3)
        if _sanitize.enabled("retrace"):
            # warmup ran every program at its serving signatures: from
            # here any growth breaks the zero-retrace contract (polled
            # once a decode wave)
            _sanitize.arm()
        if _sanitize.enabled("slot"):
            with self._cv:
                if self._canary is None:
                    self._canary = _sanitize.SlotCanary(self.pool)
        # the flight recorder's crash hooks (armed only while
        # MXNET_FLIGHTREC_DIR is set) and the OOM excepthook
        _trace.install_crash_hooks()
        mem_install_oom_hook()
        self._thread.start()
        return self

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _warmup(self):
        """Inactive lanes only: every write lands in the garbage row. Runs
        each program at the signatures serving gives it: the prefill, the
        decode with an all-greedy wave (no sampling tensors) and with a
        sampled one, every chunk extent, and the row copy."""
        g = self.pool.garbage_row
        P, S, W = self.prefill_lanes, self.pool.max_slots, \
            self.prefill_window
        kb, vb = self.pool.buffers()
        zeros = self._tensor(_np.zeros((S,), dtype=_np.int32))
        self._prefill_prog(
            self.model.params, kb, vb,
            self._tensor(_np.zeros((P, W), dtype=_np.int32)),
            self._tensor(_np.ones((P,), dtype=_np.int32)),
            self._tensor(_np.full((P,), g, dtype=_np.int32)))
        lanes = _LaneSampling(S)
        lanes.temps[:] = 1.0            # a sampled wave's tensors; idle lanes
        sampled = _sampling_tensors(*lanes.host(), self.device)
        for sampling in ((None, None, None, None), sampled):
            args = [self.model.params, kb, vb, zeros, zeros, zeros,
                    *sampling]
            if self.draft_tokens:
                args.append(self._tensor(
                    _np.zeros((S, self.max_len), dtype=_np.int32)))
            self._decode_prog(*args)
        if self._chunk_progs is not None:
            ctoks = self._tensor(_np.zeros((S, W), dtype=_np.int32))
            for prog in self._chunk_progs.values():
                prog(self.model.params, kb, vb, ctoks, zeros, zeros)
        if self._copy_prog is not None:
            self._dispatch_copy([])     # garbage onto garbage
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        return self.start()

    def close(self, drain=True, timeout=60.0):
        """Stop the scheduler. `drain=True` finishes admitted AND waiting
        requests first; `drain=False` fails the waiting queue (admitted
        requests still finish — their slots hold real state)."""
        with self._cv:
            if not self._closing:
                self._closing = True
                self._drain = drain
                pending = [] if drain else list(self._waiting)
                if not drain:
                    self._waiting.clear()
            else:
                pending = []
            self._cv.notify_all()
        for req in pending:
            _fail(req, ServerClosed("engine closed before admission"))
        if self._started:
            self._thread.join(timeout=timeout)
        with self._cv:
            canary, self._canary = self._canary, None
        if canary is not None:
            canary.release()

    def __exit__(self, *exc):
        self.close()

    def begin_drain(self):
        """Stop admitting (submit() raises `ReplicaDraining`) while the
        scheduler finishes every waiting AND admitted request.
        Non-blocking; `close()` joins after."""
        with self._cv:
            if not self._closing:
                self._closing = True
                self._drain = True
            self._cv.notify_all()

    @property
    def draining(self):
        """True while a drain is in progress (resident requests still
        finishing); False once the scheduler has exited."""
        return self._closing and self._drain and self._thread.is_alive()

    def queue_depth(self):
        """(waiting, running) request counts — the fleet router's
        least-loaded placement signal. Mid-prefill (chunk-streaming)
        requests hold slots, so they count as running."""
        with self._cv:
            return (len(self._waiting),
                    len(self._running) + len(self._prefilling))

    def prefix_hit_count(self):
        """Lifetime prefix-cache hits — the count the replica heartbeat
        carries (the full breakdown is in `stats()`)."""
        with self._mlock:
            return self._counters["prefix_hits"]

    def compile_cache_size(self):
        """The model's distinct program signatures (`CachedDecoder.
        compile_cache_size`)."""
        return self.model.compile_cache_size()

    def retraces_after_warmup(self):
        """Program-signature growth since start() — MUST be 0 in steady
        state (-1 before start())."""
        if self._warm_cache_size is None:
            return -1
        return self.model.compile_cache_size() - self._warm_cache_size

    def assert_no_retraces(self):
        """Raise when a program ran a signature warmup did not; returns
        the growth (0, or -1 before start())."""
        r = self.retraces_after_warmup()
        if r > 0:
            raise MXNetError(
                f"continuous engine retraced {r} program(s) after warmup "
                f"— a shape leaked into a step program")
        return r

    # -- submission --------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens=16, deadline_ms=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None):
        """Enqueue one generation request; returns a Future resolving to
        the np.int32 array of generated token ids (cut at `eos_id`,
        `max_new_tokens`, or a full KV page).

        `temperature=0` (default) is greedy; `temperature > 0` samples
        with optional `top_k`/`top_p` truncation, deterministically in
        `seed` (auto-assigned from a per-engine counter when omitted)."""
        temperature = float(temperature)
        if temperature < 0.0:
            raise ServeError("temperature must be >= 0")
        top_k = int(top_k)
        if top_k < 0:
            raise ServeError("top_k must be >= 0")
        top_p = float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise ServeError(f"top_p must be in (0, 1], got {top_p}")
        if not self._started:
            raise ServeError(
                "ContinuousEngine.start() (or `with engine:`) first")
        prompt = _np.asarray(prompt_tokens, dtype=_np.int32).ravel()
        if prompt.size < 1:
            raise ServeError("prompt must have at least one token")
        if prompt.size >= self.max_len:
            raise ServeError(
                f"prompt length {prompt.size} >= max_len {self.max_len} "
                f"(one slot page holds prompt + generated tokens)")
        if max_new_tokens < 1:
            raise ServeError("max_new_tokens must be >= 1")
        _fault.inject("serve.enqueue")
        dl = (deadline_ms / 1e3 if deadline_ms is not None
              else self.default_deadline_s)
        if seed is None:
            with self._mlock:
                seed = self._auto_seed
                self._auto_seed += 1
        ctx = _trace.request_root("serve.request")
        req = _GenRequest(prompt, int(max_new_tokens),
                          None if dl is None else time.perf_counter() + dl,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, key=_seed_key(seed), ctx=ctx)
        with self._cv:
            if self._closing:
                if self._drain and self._thread.is_alive():
                    raise ReplicaDraining(
                        "engine is draining (finishing resident requests "
                        "before restart); route to another replica")
                raise ServerClosed("engine is closed")
            depth = len(self._waiting)
            rejected = depth >= self.max_queue
            if not rejected:
                self._waiting.append(req)
                self._cv.notify()
        if rejected:
            self._count("rejected")
            _trace.flightrec_record(
                "serve.reject", self.name, depth=depth,
                trace_id=ctx.trace_id if ctx else None)
            _trace.flightrec_maybe_dump("serve.overload")
            raise QueueFullError(
                f"waiting queue full ({self.max_queue}); request "
                f"rejected", policy="reject")
        self._count("requests")
        return req.future

    def generate(self, prompt_tokens, max_new_tokens=16, timeout=None,
                 deadline_ms=None, temperature=0.0, top_k=0, top_p=1.0,
                 seed=None):
        """submit() + wait."""
        return self.submit(prompt_tokens, max_new_tokens,
                           deadline_ms=deadline_ms,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed).result(timeout=timeout)

    # -- metrics -----------------------------------------------------------
    def _count(self, key, n=1):
        with self._mlock:
            self._counters[key] += n
        stats_key = _ENGINE_TO_SERVE_KEY.get(key)
        if stats_key is not None:
            with _STATS_LOCK:
                SERVE_STATS[stats_key] += n

    def stats(self):
        """Plain-data snapshot: counters, slot occupancy, TTFT/TPOT/e2e
        percentiles, decode tokens/s, draft acceptance and the prefix
        cache's hit rate."""
        with self._mlock:
            c = dict(self._counters)
            ttft = sorted(self._ttft_ms)
            tpot = sorted(self._tpot_ms)
            e2e = sorted(self._e2e_ms)
            elapsed = time.perf_counter() - self._t0
        out = dict(c)
        out["elapsed_s"] = round(elapsed, 3)
        out["decode_tokens_per_sec"] = round(
            c["decode_tokens"] / elapsed, 2) if elapsed > 0 else 0.0
        out["mean_active_slots"] = round(
            c["active_sum"] / c["decode_iterations"], 3) \
            if c["decode_iterations"] else 0.0
        for nm, vals in (("ttft", ttft), ("tpot", tpot), ("e2e", e2e)):
            for q in (50, 99):
                v = percentile(vals, q)
                out[f"{nm}_p{q}_ms"] = round(v, 3) if v is not None \
                    else None
        out["pool"] = self.pool.stats()
        out["decode_steps"] = self.decode_steps
        out["draft_tokens"] = self.draft_tokens
        if c["draft_accepted"] + c["draft_rejected"] > 0:
            out["draft_acceptance"] = round(
                c["draft_accepted"]
                / (c["draft_accepted"] + c["draft_rejected"]), 4)
        out["prefill_lanes"] = self.prefill_lanes
        out["prefill_window"] = self.prefill_window
        out["compile_cache_size"] = self.compile_cache_size()
        out["retraces_after_warmup"] = self.retraces_after_warmup()
        if self._cache is not None:
            out["prefix_block"] = self.prefix_block
            out["prefix_cache"] = self._cache.stats()
            if c["prefix_hits"] + c["prefix_misses"] > 0:
                out["prefix_hit_rate"] = round(
                    c["prefix_hits"]
                    / (c["prefix_hits"] + c["prefix_misses"]), 4)
            if c["prefill_tokens"] + c["prefix_cached_tokens"] > 0:
                # share of prompt tokens served by copy, not compute
                out["prefill_cached_token_share"] = round(
                    c["prefix_cached_tokens"]
                    / (c["prefill_tokens"] + c["prefix_cached_tokens"]),
                    4)
        out["device"] = str(self.device)
        return out

    # -- scheduler ---------------------------------------------------------
    def _loop(self):
        try:
            self._serve()
        except BaseException as e:
            # the scheduler itself died: no request may wait forever on it
            with self._cv:
                self._closing = True
                doomed = (list(self._waiting) + list(self._running.values())
                          + list(self._prefilling.values()))
                self._waiting.clear()
                self._running.clear()
                self._prefilling.clear()
            for req in doomed:
                _fail(req, ServeError(
                    f"engine scheduler died: {type(e).__name__}: {e}"))
            raise

    def _serve(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while (not self._waiting and not self._running
                       and not self._prefilling and not self._closing):
                    self._cv.wait()
                if self._closing and not self._running \
                        and not self._prefilling \
                        and (not self._drain or not self._waiting):
                    for req in self._waiting:
                        _fail(req, ServerClosed(
                            "engine closed before admission"))
                    self._waiting.clear()
                    return
                admitted, expired = self._admit_locked()
            # expired waiters resolve OUTSIDE self._cv: Future callbacks
            # run inline and may re-enter submit()
            now = time.perf_counter()
            for req in expired:
                self._count("timeouts")
                _trace.flightrec_record(
                    "serve.timeout", self.name,
                    waited_ms=round((now - req.t_submit) * 1e3, 1),
                    trace_id=req.ctx.trace_id if req.ctx else None)
                _fail(req, RequestTimeout(
                    f"deadline expired after "
                    f"{(now - req.t_submit) * 1e3:.1f}ms waiting for a "
                    f"KV slot"))
            if (not admitted and not expired and not self._running
                    and not self._prefilling):
                # waiting requests exist but no slot freed up (something
                # outside the engine holds claims): timed wait, re-check
                with self._cv:
                    if (self._waiting and not self._running
                            and not self._prefilling):
                        self._cv.wait(timeout=0.005)
                continue
            try:
                # _prefilling is only ever mutated on this thread
                if admitted or self._prefilling:
                    self._run_prefill(admitted)
                if self._running:
                    self._run_decode()
            except Exception as e:
                # a step failure fails the IN-FLIGHT requests, frees their
                # slots, and the engine keeps serving. The slabs need no
                # reallocation (they are updated in place, never donated):
                # whatever a failed step half-wrote lies outside every
                # later request's [0, cur_len] mask. An OOM leaves its
                # black box first (mem_on_oom never raises).
                mem_on_oom(e, where="serve.continuous")
                err = e if isinstance(e, MXNetError) else ServeError(
                    f"engine step failed: {type(e).__name__}: {e}")
                with self._cv:
                    doomed = (list(self._running.values())
                              + list(self._prefilling.values()))
                    self._running.clear()
                    self._prefilling.clear()
                for req in doomed:
                    if req.entry is not None:
                        self._cache.release(req.entry)
                        req.entry = None
                    if req.slot is not None:
                        self.pool.free(req.slot)
                    _fail(req, err)
                self._count("errors", len(doomed))
                if self._cache is not None:
                    # a publish copy may have been cut mid-row: drop the
                    # index (its rows stay claimed and refill later)
                    self._cache.clear()  # mxlint: disable=lock-shared-mutation -- PrefixCache serializes internally (leaf lock); every ref was just released above
                # the sanitizer's state after a violation (or any failed
                # wave): the canary row poisoned again, the sentinel
                # re-baselined, and the engine keeps serving
                if self._canary is not None:
                    self._canary.rearm()
                if _sanitize.enabled("retrace"):
                    _sanitize.arm()

    def _admit_locked(self):
        """Deadline-aware admission (runs under self._cv): drop expired
        waiters from the queue, then grant free slots
        earliest-deadline-first within the prefill token budget. A
        waiter's cost is its POST-CACHE cost, the tokens its first wave
        processes (the uncached suffix), capped at one window; chunks
        already streaming bill the budget first; a waiter over budget is
        skipped so a cheaper one may fit. A prefix-cache hit pins its
        entry for the request's lifetime. Returns (admitted, expired); the
        caller resolves expired futures off-lock."""
        now = time.perf_counter()
        expired = [r for r in self._waiting
                   if r.deadline is not None and now > r.deadline]
        if expired:
            dropset = set(id(r) for r in expired)
            self._waiting = deque(r for r in self._waiting  # mxlint: disable=lock-shared-mutation -- _admit_locked runs with self._cv held by its only caller (_loop)
                                  if id(r) not in dropset)
        admitted = []
        budget = self.prefill_budget
        for req in self._prefilling.values():
            budget -= min(self.prefill_window,
                          int(req.prompt.size) - req.prefill_pos)
        free = self.pool.free_count()
        if free and self._waiting:
            costs = {}
            for req in self._waiting:
                mlen = 0
                if self._cache is not None:
                    _, mlen = self._cache.match(req.prompt, acquire=False)
                costs[id(req)] = min(int(req.prompt.size) - mlen,
                                     self.prefill_window)
            ranked = sorted(
                self._waiting,
                key=lambda r: r.sort_key()[:2] + (costs[id(r)], r.t_submit))
            for req in ranked:
                if not free or len(admitted) >= self.prefill_lanes:
                    break
                cost = costs[id(req)]
                if admitted and budget - cost < 0:
                    continue    # over budget; a cheaper waiter may fit
                try:
                    req.slot = self.pool.claim()
                except SlotsFullError:   # raced a direct claim
                    break
                if self._cache is not None:
                    entry, mlen = self._cache.match(req.prompt)
                    if entry is not None:
                        req.entry = entry
                        req.cached_len = mlen
                        req.prefill_pos = mlen
                free -= 1
                budget -= cost
                admitted.append(req)
            if admitted:
                dropset = set(id(r) for r in admitted)
                self._waiting = deque(r for r in self._waiting  # mxlint: disable=lock-shared-mutation -- _admit_locked runs with self._cv held by its only caller (_loop)
                                      if id(r) not in dropset)
        for req in admitted:
            self._prefilling[req.slot] = req  # mxlint: disable=lock-shared-mutation -- _admit_locked runs with self._cv held by its only caller (_loop)
        return admitted, expired

    def _run_prefill(self, admitted):
        """One prefill wave: whole-row KV copies for the admitted
        prefix-cache hits, the windowed program for the cold admissions
        (page offset 0), then ONE chunk dispatch advancing EVERY lane with
        suffix or chunk work (admitted hits and long prompts mid-stream
        alike). A request emits its first token the wave its prefill
        completes; `prefill_tokens` bills only tokens a program processed
        (suffix-only on a hit)."""
        _fault.inject("serve.execute")
        t0 = time.perf_counter()
        W = self.prefill_window
        g = self.pool.garbage_row
        params = self.model.params
        hits = [r for r in admitted if r.cached_len > 0]
        cold = [r for r in admitted if r.cached_len == 0]
        if hits:
            # the pinned cache rows land in the claimed slots before this
            # wave's programs run (same thread, same stream)
            self._dispatch_copy([(r.entry.row, r.slot) for r in hits])
            self._count("prefix_hits", len(hits))
            self._count("prefix_cached_tokens",
                        int(sum(r.cached_len for r in hits)))
        if self._cache is not None and cold:
            self._count("prefix_misses", len(cold))
        kb, vb = self.pool.buffers()
        n_tokens = 0
        finished = []                        # (req, first token)
        if cold:
            P = self.prefill_lanes
            toks = _np.zeros((P, W), dtype=_np.int32)
            lens = _np.ones((P,), dtype=_np.int32)
            rows = _np.full((P,), g, dtype=_np.int32)
            samp = _LaneSampling(P)
            for i, req in enumerate(cold):
                head = min(int(req.prompt.size), W)
                toks[i, :head] = req.prompt[:head]
                lens[i] = head
                rows[i] = req.slot
                samp.set(i, req)
            logits = self._prefill_prog(
                params, kb, vb, self._tensor(toks), self._tensor(lens),
                self._tensor(rows))
            first_host = _sample_first(logits, *samp.host(), lens - 1)
            for i, req in enumerate(cold):
                head = min(int(req.prompt.size), W)
                req.prefill_pos = head
                n_tokens += head
                if head == req.prompt.size:
                    finished.append((req, int(first_host[i])))
        # chunk wave: admitted hits prefill their suffix, long prompts
        # mid-stream advance one window — ONE dispatch at pool width;
        # lanes with no chunk work write garbage
        with self._cv:
            pre = [self._prefilling[s] for s in sorted(self._prefilling)]
        coldset = set(id(r) for r in cold)
        chunkers = [r for r in pre
                    if id(r) not in coldset
                    and r.prefill_pos < int(r.prompt.size)]
        if chunkers:
            S = self.pool.max_slots
            ctoks = _np.zeros((S, W), dtype=_np.int32)
            offs = _np.zeros((S,), dtype=_np.int32)
            nval = _np.zeros((S,), dtype=_np.int32)
            samp = _LaneSampling(S)
            fold = _np.zeros((S,), dtype=_np.int64)
            for req in chunkers:
                s = req.slot
                n = min(W, int(req.prompt.size) - req.prefill_pos)
                ctoks[s, :n] = req.prompt[req.prefill_pos:
                                          req.prefill_pos + n]
                offs[s] = req.prefill_pos
                nval[s] = n
                samp.set(s, req)
                fold[s] = int(req.prompt.size) - 1
            # smallest extent covering the furthest lane
            need = int((offs + nval).max())
            ext = next(x for x in self._chunk_extents if x >= need)
            logits = self._chunk_progs[ext](
                params, kb, vb, self._tensor(ctoks), self._tensor(offs),
                self._tensor(nval))
            first_host = _sample_first(logits, *samp.host(), fold)
            for req in chunkers:
                n = int(nval[req.slot])
                req.prefill_pos += n
                n_tokens += n
                if req.prefill_pos == int(req.prompt.size):
                    finished.append((req, int(first_host[req.slot])))
            self._count("chunk_batches")
        now = time.perf_counter()
        if admitted:
            self._count("admitted", len(admitted))
        if cold or chunkers:
            self._count("prefill_batches")
        if n_tokens:
            self._count("prefill_tokens", n_tokens)
        n_sampled = sum(1 for r, _ in finished if r.temperature > 0)
        if n_sampled:
            self._count("sampled_tokens", n_sampled)
        prof = _trace._profiler_running()
        done = []
        for req, tok in finished:
            req.cache_len = int(req.prompt.size)
            req.generated.append(tok)
            req.t_first = req.t_last = now
            with self._mlock:
                self._ttft_ms.append((now - req.t_submit) * 1e3)
            if req.ctx is not None and prof:
                # admission -> first token, a child of the request root
                record_span("serve.prefill", (now - req.t_submit) * 1e6,
                            ts_us=req.t_submit * 1e6, cat="serve",
                            ctx=_trace.child_context(req.ctx,
                                                     "serve.prefill"),
                            prompt_tokens=req.prompt.size,
                            cached_tokens=req.cached_len,
                            slot=req.slot)
            if self._finished(req):
                done.append(req)
        with self._cv:
            for req, _ in finished:
                self._prefilling.pop(req.slot, None)
                self._running[req.slot] = req
        if _trace.enabled() and _trace.collector_active():
            record_span("serve.prefill_batch", (now - t0) * 1e6,
                        ts_us=t0 * 1e6, cat="serve",
                        requests=len(admitted), tokens=n_tokens)
        self._retire(done)

    def _dispatch_copy(self, pairs):
        """Copy whole KV slot rows slab-to-slab, (src, dst) pairs: cache
        row -> claimed slot at admission, retiring slot -> cache row at
        publish. ONE fixed shape, as the JAX package's: `prefill_lanes`
        lanes, the idle ones copying the garbage row onto itself."""
        g = self.pool.garbage_row
        src = _np.full((self.prefill_lanes,), g, dtype=_np.int64)
        dst = _np.full((self.prefill_lanes,), g, dtype=_np.int64)
        for i, (s, d) in enumerate(pairs):
            src[i] = s
            dst[i] = d
        self._copy_prog(*self.pool.buffers(), self._tensor(src),
                        self._tensor(dst))

    def _run_decode(self):
        """ONE decode wave: every active slot advances up to
        `decode_steps` micro-steps (each up to `draft_tokens + 1` tokens
        when speculating). Lanes are ALL pool rows (request slots,
        mid-prefill slots and prefix-cache rows alike), so lane index ==
        slab row; non-decoding lanes are inactive and write into the
        garbage row."""
        t0 = time.perf_counter()
        S = self.pool.max_slots
        draft = self.draft_tokens
        toks = _np.zeros((S,), dtype=_np.int32)
        lens = _np.zeros((S,), dtype=_np.int32)
        left = _np.zeros((S,), dtype=_np.int32)
        samp = _LaneSampling(S)
        buf = (_np.zeros((S, self.max_len), dtype=_np.int32)
               if draft else None)
        with self._cv:
            running = dict(self._running)
        for slot, req in running.items():
            toks[slot] = req.generated[-1]
            lens[slot] = req.cache_len
            # this wave's per-lane budget: what the request still wants,
            # capped so cache_len advances at most to max_len - 1 (the
            # single-step reference emits its last token from state
            # max_len - 2; one more would break decode_steps invariance)
            left[slot] = min(req.max_new - len(req.generated),
                             self.max_len - 1 - req.cache_len)
            samp.set(slot, req)
            if draft:
                # the draft source: prompt + generated, exactly
                # cache_len + 1 valid entries (the tail is not in KV yet)
                plen = req.prompt.size
                buf[slot, :plen] = req.prompt
                buf[slot, plen:plen + len(req.generated)] = req.generated
        kb, vb = self.pool.buffers()
        args = [self.model.params, kb, vb, self._tensor(toks),
                self._tensor(lens), self._tensor(left),
                *_sampling_tensors(*samp.host(), self.device)]
        if draft:
            blocks, n_emits, emitted, acc, rej = self._decode_prog(
                *args, self._tensor(buf))
        else:
            out_toks, emitted = self._decode_prog(*args)
        if self._canary is not None:
            # queued behind the wave; reads the previous wave's probe
            self._canary.check(where="serve.decode")
        _sanitize.poll(where="serve.decode")
        if draft:
            blocks_host = blocks.cpu().numpy()    # (steps, S, draft+1)
            nem_host = n_emits.cpu().numpy()      # (steps, S)
        else:
            out_host = out_toks.cpu().numpy()     # (decode_steps, S)
        emitted_host = emitted.cpu().numpy()
        now = time.perf_counter()
        n_tokens = 0
        n_sampled = 0
        done = []
        for slot, req in running.items():
            n_new = int(emitted_host[slot])
            if n_new > 0:
                if draft:
                    for i in range(nem_host.shape[0]):
                        m = int(nem_host[i, slot])
                        req.generated.extend(
                            int(t) for t in blocks_host[i, slot, :m])
                else:
                    req.generated.extend(
                        int(t) for t in out_host[:n_new, slot])
                req.cache_len += n_new
                req.t_last = now
                n_tokens += n_new
                if req.temperature > 0:
                    n_sampled += n_new
            if self._finished(req):
                done.append(req)
        self._count("decode_iterations")
        self._count("decode_tokens", n_tokens)
        self._count("active_sum", len(running))
        if n_sampled:
            self._count("sampled_tokens", n_sampled)
        if draft:
            self._count("draft_accepted", int(acc.sum()))
            self._count("draft_rejected", int(rej.sum()))
        if _trace.enabled() and _trace.collector_active():
            now = time.perf_counter()
            record_span("serve.decode_batch", (now - t0) * 1e6,
                        ts_us=t0 * 1e6, cat="serve", active=len(running),
                        tokens=n_tokens, steps=self.decode_steps)
        self._retire(done)

    def _finished(self, req):
        if len(req.generated) >= req.max_new:
            return True
        if self.eos_id is not None and req.generated[-1] == self.eos_id:
            return True
        # page full: the NEXT decode would write past the slot
        return req.cache_len + 1 >= self.max_len

    def _retire(self, done):
        """Publish prompt prefixes into the cache (cold requests) or
        release the pinned entry (hits), free slots and resolve
        futures."""
        prof = _trace._profiler_running()
        for req in done:
            with self._cv:
                self._running.pop(req.slot, None)
            if self._cache is not None:
                if req.entry is not None:
                    # a hit never publishes: its suffix KV came from the
                    # chunk program, and the cache keeps cold provenance
                    # (windowed head + chunks) so every later hit is the
                    # cold build's
                    self._cache.release(req.entry)  # mxlint: disable=lock-shared-mutation -- PrefixCache serializes internally (leaf lock)
                    req.entry = None
                elif self.prefix_cache_insert:
                    row = self._cache.insert(req.prompt)  # mxlint: disable=lock-shared-mutation -- PrefixCache serializes internally (leaf lock)
                    if row is not None:
                        # publish BEFORE free: the copy is queued on this
                        # thread ahead of any wave that could rewrite the
                        # retiring slot's row
                        self._dispatch_copy([(req.slot, row)])
            self.pool.free(req.slot)
            out = _np.asarray(req.generated, dtype=_np.int32)
            if self.eos_id is not None:
                hits = _np.nonzero(out == self.eos_id)[0]
                if hits.size:
                    out = out[:int(hits[0]) + 1]
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(out)
            now = time.perf_counter()
            total_ms = (now - req.t_submit) * 1e3
            with self._mlock:
                self._e2e_ms.append(total_ms)
                if len(req.generated) > 1 and req.t_first is not None:
                    self._tpot_ms.append(
                        (req.t_last - req.t_first) * 1e3
                        / (len(req.generated) - 1))
            self._count("replies")
            self._count("retired")
            if req.ctx is not None and prof:
                if req.t_first is not None and req.t_last > req.t_first:
                    # first -> last token: the decode iterations as one
                    # node (the batch lane has them one by one)
                    record_span("serve.decode",
                                (req.t_last - req.t_first) * 1e6,
                                ts_us=req.t_first * 1e6, cat="serve",
                                ctx=_trace.child_context(req.ctx,
                                                         "serve.decode"),
                                tokens=len(req.generated), slot=req.slot)
                record_span("serve.request", total_ms * 1e3,
                            ts_us=req.t_submit * 1e6, cat="serve",
                            ctx=req.ctx, tokens=len(req.generated))


# engine counter -> process-wide SERVE_STATS key
_ENGINE_TO_SERVE_KEY = {
    "requests": "requests", "replies": "replies",
    "rejected": "rejected", "timeouts": "timeouts", "errors": "errors",
    "decode_iterations": "decode_iterations",
    "decode_tokens": "decode_tokens",
    "prefill_tokens": "decode_prefill_tokens",
    "admitted": "decode_admitted",
    "retired": "decode_retired",
    "sampled_tokens": "decode_sampled_tokens",
    "draft_accepted": "decode_draft_accepted",
    "draft_rejected": "decode_draft_rejected",
}
