"""Continuous (iteration-level) batching for autoregressive models, in
PyTorch.

Counterpart of `incubator_mxnet_tpu/serve/continuous.py`, same layout and
names:

  * **Slot memory** (`serve.kv_pool.KVCachePool`): a fixed-shape KV slab
    carved once; each admitted request claims a slot ROW; join/leave is
    host bookkeeping.
  * **Step programs**: `prefill` (a windowed causal forward over a padded
    prompt page, KV written into the claimed rows), `chunk_prefill` (one
    window-sized slice of a long prompt at a page offset) and `decode`
    (every pool row advances up to `steps` tokens; inactive lanes write
    into the garbage row). PyTorch runs them eagerly: a "program" is a
    plain function over tensors, and the `steps` loop is a Python loop
    with no host synchronisation inside it.
  * **In-place slab updates**: the programs write K/V into `pool.k` and
    `pool.v` by indexed assignment, where the JAX package donates the
    buffers to a jitted program and swaps in its outputs.
  * **Paged attention**: the decode and chunk attention reads go through
    `ops.fused.paged_attention` — the hand-written CUDA kernel
    (`ops/csrc/paged_attention.cu`) for tensors on the card, the plain
    masked-einsum version for tensors on the CPU.
  * **Iteration-level scheduling**: every engine iteration retires
    finished requests, admits waiting ones earliest-deadline-first under
    a prefill token budget, streams long prompts in window-sized chunks,
    then runs one decode wave over every active slot.

This slice serves GREEDY requests only. Sampling (`temperature > 0`,
`top_k`, `top_p`), speculative decoding (`draft_tokens > 0`), int8 KV and
the shared-prefix cache raise a typed `ServeError`. Telemetry spans, fault
points, the sanitizer and the `mx.tune` profile lookup are not ported.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, get_env, torch_dtype
from ..device import resolve_device
from ..ops import fused as _fused
from .batcher import (ServeError, QueueFullError, RequestTimeout,
                      ServerClosed, ReplicaDraining, _fail)
from .metrics import SERVE_STATS, _STATS_LOCK, percentile
from .kv_pool import KVCachePool, SlotsFullError

__all__ = ["DecoderConfig", "CachedDecoder", "ContinuousEngine",
           "init_decoder_params", "params_from_jax"]


# ---------------------------------------------------------------------------
# model: a small cached-KV transformer decoder (greedy, deterministic)
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


def _rmsnorm(x, scale):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * scale / torch.sqrt(var + 1e-6)


def _mlp(x, params, l):
    h2 = _rmsnorm(x, params["ln2"][l])
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h2 @ params["w1"][l], approximate="tanh") @ params["w2"][l]


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _store_page(cache, rows, l, W, val):
    """Write a (P, W, H, D) KV page into [rows, l, :W], in place."""
    cache[:, l][rows, :W] = val.to(cache.dtype)


def _store_pos(cache, rows, l, wpos, val):
    """Write KV at explicit positions (rows/wpos broadcast to the leading
    dims of `val`), in place."""
    cache[:, l][rows, wpos] = val.to(cache.dtype)


def _paged_attn(k_cache, v_cache, q, lengths, l, extent=None):
    """Decode-side attention read over the slot slab via
    `ops.fused.paged_attention`. q is (S, C, H, D); chunk offset j reads
    positions [0, lengths + j].

    `extent` cuts the slab's position axis to [0, extent) as a VIEW (no
    copy; the kernel reads it through its strides): when the caller can
    bound `lengths + j < extent` for every lane, the positions beyond it
    are masked either way, so the output is the full-width read's."""
    if extent is not None and extent < k_cache.shape[2]:
        k_cache = k_cache[:, :, :extent]
        v_cache = v_cache[:, :, :extent]
    lengths = lengths.to(torch.int32).contiguous()
    return _fused.paged_attention(q.contiguous(), k_cache, v_cache,
                                  lengths, l)


def _make_prefill(config, window=None):
    """Build the prefill step: full causal forward over the padded prompt
    page, KV written into the claimed slot rows, logits at each lane's
    last prompt position.

    `prefill(params, k_cache, v_cache, tokens, lengths, slot_rows) ->
    logits (P, vocab)`; tokens (P, W), lengths and slot_rows (P,). The
    caches are updated in place. A lane with no request carries
    slot_row = garbage. Slot positions past the window keep the previous
    tenant's bytes, which the decode mask never reaches."""
    c = config
    W = int(window if window is not None else c.max_len)
    if not 1 <= W <= c.max_len:
        raise ServeError(f"prefill window {W} outside [1, {c.max_len}]")
    scale = 1.0 / _np.sqrt(c.head_dim)

    def prefill(params, k_cache, v_cache, tokens, lengths, slot_rows):
        P = tokens.shape[0]
        dev = tokens.device
        lengths = lengths.long()
        x = params["emb"][tokens.long()] + params["pos"][None, :W]
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
            scores = scores.masked_fill(~mask, -1e30)
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
    longer than `prefill_window` stream in across waves.

    `chunk_prefill(params, k_cache, v_cache, tokens, offsets, nvalid) ->
    logits (S, vocab)`; tokens (S, W), offsets and nvalid (S,). Lanes are
    POOL ROWS (lane s writes row s); a lane with `nvalid == 0` writes into
    the garbage row. Logits come from each lane's last valid chunk
    position. `extent` bounds the attention read to slab positions
    [0, extent): valid for a wave whose furthest lane satisfies
    offset + nvalid <= extent."""
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
        x = params["emb"][tokens.long()] + params["pos"][wposs]
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

    `decode(params, k_cache, v_cache, tokens, lengths, steps_left) ->
    (out_tokens (steps, S) int32, emitted (S,) int32)`. `emitted[s]` is
    the exact number of tokens lane s produced this wave (rows
    [0:emitted] of its column), counted in the loop because `eos_id`
    zeroes a lane's remaining budget mid-wave. The caches are updated in
    place, and nothing in the loop waits for the device."""
    c = config

    def micro(params, k_cache, v_cache, tokens, lengths, active):
        # one token for every active lane; the new token's KV lands at
        # position `lengths`, and attention reads 0..lengths inclusive
        S = tokens.shape[0]
        T = c.max_len
        dev = tokens.device
        rows = torch.where(active, torch.arange(S, device=dev), S)
        wpos = torch.clamp(lengths, 0, T - 1).long()
        x = params["emb"][tokens.long()] + params["pos"][wpos]   # (S, E)
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
        return torch.where(active, _greedy(logits), 0)

    def decode(params, k_cache, v_cache, tokens, lengths, steps_left):
        last = tokens.to(torch.int32)
        lens = lengths.to(torch.int32)
        left = steps_left.to(torch.int32)
        emitted = torch.zeros_like(left)
        out = []
        for _ in range(steps):
            act = left > 0
            nxt = micro(params, k_cache, v_cache, last, lens, act)
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


def _unported(temperature=0.0, top_k=0, top_p=1.0, draft_tokens=0,
              kv_dtype=None, prefix_cache=False):
    """Typed refusal of what this slice of the port does not serve."""
    if float(temperature) > 0 or int(top_k) != 0 or float(top_p) != 1.0:
        raise ServeError(
            "sampling (temperature > 0, top_k, top_p) is not ported to "
            "PyTorch yet; this engine serves greedy requests only")
    if int(draft_tokens) != 0:
        raise ServeError("speculative decoding (draft_tokens > 0) is not "
                         "ported to PyTorch yet")
    if kv_dtype == "int8":
        raise ServeError("int8 KV is not ported to PyTorch yet")
    if prefix_cache:
        raise ServeError("the shared-prefix KV cache is not ported to "
                         "PyTorch yet")


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

    def new_pool(self, max_slots=None, dtype=None):
        c = self.config
        return KVCachePool(max_slots, layers=c.layers, max_len=c.max_len,
                           heads=c.heads, head_dim=c.head_dim,
                           dtype=dtype or c.dtype, device=self.device)

    def prefill_program(self, window):
        """The prefill program for a prompt-page width."""
        return _make_prefill(self.config, window=int(window))

    def chunk_prefill_program(self, window, extent=None):
        """The CHUNK prefill program for a (window, extent) pair."""
        return _make_chunk_prefill(self.config, window=int(window),
                                   extent=extent)

    def decode_program(self, steps, eos_id=None):
        """The decode program for a (steps, eos) variant."""
        return _make_decode(self.config, steps=int(steps), eos_id=eos_id)

    def _ints(self, a):
        return torch.as_tensor(_np.asarray(a, dtype=_np.int32),
                               device=self.device)

    def prefill(self, k_cache, v_cache, tokens, lengths, slot_rows):
        """Prefill (window = the token page width) and return each lane's
        greedy first token, (P,) int32."""
        logits = self.prefill_program(tokens.shape[1])(
            self.params, k_cache, v_cache, tokens, lengths, slot_rows)
        return _greedy(logits)

    def decode(self, k_cache, v_cache, tokens, lengths, steps_left,
               steps=1, eos_id=None):
        """One decode wave: `(out_tokens (steps, S), emitted (S,))`."""
        return self.decode_program(steps, eos_id)(
            self.params, k_cache, v_cache, tokens, lengths, steps_left)

    def reference_generate(self, prompt, max_new_tokens, eos_id=None,
                           window=None, temperature=0.0, top_k=0,
                           top_p=1.0, seed=0, draft_tokens=0,
                           kv_dtype=None, cached_prefix_len=0):
        """Generation through a PRIVATE 1-slot pool — the scheduling-free
        reference the engine's mixed-batch outputs must match
        token-for-token. Pass the engine's `prefill_window`: prompts
        longer than the window replay the engine's CHUNKED prefill (a
        windowed first chunk at offset 0, then window-sized slices through
        the chunk program). Greedy only: sampling, speculative decoding,
        int8 KV and prefix-cache hits raise `ServeError`."""
        _unported(temperature, top_k, top_p, draft_tokens, kv_dtype,
                  prefix_cache=cached_prefix_len != 0)
        pool = self.new_pool(max_slots=1)
        k, v = pool.buffers()
        W = int(window if window is not None else self.config.max_len)
        prompt = _np.asarray(prompt, dtype=_np.int32).ravel()
        plen = int(prompt.size)
        if plen < 1 or plen >= self.config.max_len:
            raise ServeError(
                f"prompt length {plen} outside [1, max_len-1="
                f"{self.config.max_len - 1}]")
        head = min(plen, W)
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
        out = [int(_greedy(logits)[0])]
        cache_len = plen
        step = self.decode_program(1)
        while (len(out) < max_new_tokens
               and (eos_id is None or out[-1] != eos_id)
               and cache_len + 1 < self.config.max_len):
            toks1, _ = step(self.params, k, v, self._ints([out[-1]]),
                            self._ints([cache_len]), self._ints([1]))
            out.append(int(toks1[0, 0]))
            cache_len += 1
        return _np.asarray(out, dtype=_np.int32)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class _GenRequest:
    __slots__ = ("prompt", "max_new", "future", "deadline", "t_submit",
                 "slot", "generated", "cache_len", "t_first", "t_last",
                 "prefill_pos")

    def __init__(self, prompt, max_new, deadline):
        self.prompt = prompt                 # np.int32 (plen,)
        self.max_new = max_new
        self.future = Future()
        self.deadline = deadline             # perf_counter deadline or None
        self.t_submit = time.perf_counter()
        self.slot = None
        self.generated = []
        self.cache_len = 0
        self.t_first = None                  # first token (TTFT anchor)
        self.t_last = None
        self.prefill_pos = 0     # prompt tokens already in KV (chunked)

    def sort_key(self):
        """Earliest-deadline-first; deadline-less requests rank after
        every deadline-holder, FIFO among themselves."""
        return (self.deadline is None,
                self.deadline if self.deadline is not None
                else self.t_submit,
                self.t_submit)


class ContinuousEngine:
    """Iteration-level batching decode engine over a `CachedDecoder`.

    ::

        model = serve.CachedDecoder(serve.DecoderConfig(max_len=64))
        with serve.ContinuousEngine(model, max_slots=8) as eng:
            fut = eng.submit([3, 14, 15], max_new_tokens=16)
            tokens = fut.result()            # np.int32 generated ids

    Knobs (constructor arg > MXNET_SERVE_* env > default, the JAX
    package's names):

      max_slots        KV slots = max concurrently-decoding requests
                       (MXNET_SERVE_MAX_SLOTS, 8)
      prefill_budget   max prompt TOKENS prefilled per engine iteration
                       (MXNET_SERVE_PREFILL_BUDGET, 256); >= 1 request is
                       always admitted when a slot is free
      prefill_lanes    lane count of the prefill program
                       (MXNET_SERVE_PREFILL_LANES, min(max_slots, 8))
      prefill_window   prompt page width (default max_len); longer
                       prompts stream in window-sized chunks
      decode_steps     tokens per decode wave (MXNET_SERVE_DECODE_STEPS, 4)
      max_queue        waiting-request bound, reject-newest
                       (MXNET_SERVE_MAX_QUEUE, 256)
      default_deadline_ms  queue deadline (MXNET_SERVE_DEADLINE_MS);
                       expiry while WAITING fails fast with RequestTimeout
      eos_id           token that ends a request

    `draft_tokens` (MXNET_SERVE_DRAFT_TOKENS), `kv_dtype`
    (MXNET_SERVE_KV_DTYPE) and `prefix_cache_slots`
    (MXNET_SERVE_PREFIX_CACHE_SLOTS) are resolved the same way and raise
    `ServeError` when they ask for what this slice does not serve.

    Exactly one scheduler thread runs the step programs, so the KV slabs
    have a single writer; submit() is safe from any thread.
    """

    def __init__(self, model, *, max_slots=None, prefill_budget=None,
                 prefill_lanes=None, prefill_window=None, decode_steps=None,
                 max_queue=None, default_deadline_ms=None, eos_id=None,
                 draft_tokens=None, kv_dtype=None, prefix_cache_slots=None,
                 name="serve.continuous"):
        self.model = model
        self.name = name
        self.eos_id = eos_id
        self.device = model.device
        if draft_tokens is None:
            draft_tokens = get_env("MXNET_SERVE_DRAFT_TOKENS", 0, typ=int)
        if kv_dtype is None:
            kv_dtype = get_env("MXNET_SERVE_KV_DTYPE")
        if prefix_cache_slots is None:
            prefix_cache_slots = get_env("MXNET_SERVE_PREFIX_CACHE_SLOTS",
                                         0, typ=int)
        _unported(draft_tokens=draft_tokens, kv_dtype=kv_dtype,
                  prefix_cache=int(prefix_cache_slots) != 0)
        if kv_dtype not in (None, model.config.dtype):
            raise ServeError(
                f"kv_dtype {kv_dtype!r}: the ported pool stores KV in the "
                f"model dtype ({model.config.dtype})")
        if max_slots is None:
            max_slots = get_env("MXNET_SERVE_MAX_SLOTS", 8, typ=int)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ServeError("max_slots must be >= 1")
        self.pool = model.new_pool(self.max_slots)
        if decode_steps is None:
            decode_steps = get_env("MXNET_SERVE_DECODE_STEPS", 4, typ=int)
        self.decode_steps = max(1, int(decode_steps))
        self._decode_prog = model.decode_program(self.decode_steps, eos_id)
        self.prefill_window = int(
            prefill_window if prefill_window is not None
            else model.config.max_len)
        if not 1 <= self.prefill_window <= model.config.max_len:
            raise ServeError(
                f"prefill_window must be in [1, max_len], got "
                f"{self.prefill_window}")
        self._prefill_prog = model.prefill_program(self.prefill_window)
        # chunk programs exist when a prompt can outgrow the window. They
        # form an EXTENT LADDER (window, 2*window, ... max_len): a wave's
        # attention read covers how far its furthest lane has streamed,
        # not max_len
        self._chunk_progs = None
        self._chunk_extents = ()
        if self.prefill_window < model.config.max_len:
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
        self.prefill_budget = int(
            prefill_budget if prefill_budget is not None
            else get_env("MXNET_SERVE_PREFILL_BUDGET", 256, typ=int))
        if self.prefill_budget < 1:
            raise ServeError("prefill_budget must be >= 1")
        if prefill_lanes is None:
            prefill_lanes = get_env("MXNET_SERVE_PREFILL_LANES", typ=int)
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
            "active_sum")}
        self._ttft_ms = deque(maxlen=4096)
        self._tpot_ms = deque(maxlen=4096)
        self._e2e_ms = deque(maxlen=4096)

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup=True):
        """Run one garbage-lane pass through the prefill and decode steps
        (this builds the CUDA kernels at first use and initialises the
        matrix-product libraries, so the first request does not pay for
        either), then start the scheduler thread. Returns self."""
        if self._started:
            return self
        t0 = time.perf_counter()
        if warmup:
            self._warmup()
        with self._cv:
            self._started = True
        self.warmup_s = round(time.perf_counter() - t0, 3)
        self._thread.start()
        return self

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _warmup(self):
        """Inactive lanes only: every write lands in the garbage row."""
        g = self.pool.garbage_row
        P, S, W = self.prefill_lanes, self.pool.max_slots, \
            self.prefill_window
        kb, vb = self.pool.buffers()
        zeros = _np.zeros((S,), dtype=_np.int32)
        self._prefill_prog(
            self.model.params, kb, vb,
            self._tensor(_np.zeros((P, W), dtype=_np.int32)),
            self._tensor(_np.ones((P,), dtype=_np.int32)),
            self._tensor(_np.full((P,), g, dtype=_np.int32)))
        self._decode_prog(self.model.params, kb, vb, self._tensor(zeros),
                          self._tensor(zeros), self._tensor(zeros))
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

    # -- submission --------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens=16, deadline_ms=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None):
        """Enqueue one generation request; returns a Future resolving to
        the np.int32 array of generated token ids (cut at `eos_id`,
        `max_new_tokens`, or a full KV page). Greedy only: `temperature >
        0`, `top_k` or `top_p < 1` raise `ServeError`; `seed` has no
        effect on a greedy request."""
        temperature = float(temperature)
        if temperature < 0.0:
            raise ServeError("temperature must be >= 0")
        if int(top_k) < 0:
            raise ServeError("top_k must be >= 0")
        if not 0.0 < float(top_p) <= 1.0:
            raise ServeError(f"top_p must be in (0, 1], got {top_p}")
        _unported(temperature, top_k, top_p)
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
        dl = (deadline_ms / 1e3 if deadline_ms is not None
              else self.default_deadline_s)
        req = _GenRequest(prompt, int(max_new_tokens),
                          None if dl is None else time.perf_counter() + dl)
        with self._cv:
            if self._closing:
                if self._drain and self._thread.is_alive():
                    raise ReplicaDraining(
                        "engine is draining (finishing resident requests "
                        "before restart); route to another replica")
                raise ServerClosed("engine is closed")
            rejected = len(self._waiting) >= self.max_queue
            if not rejected:
                self._waiting.append(req)
                self._cv.notify()
        if rejected:
            self._count("rejected")
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
        percentiles and decode tokens/s."""
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
        out["prefill_lanes"] = self.prefill_lanes
        out["prefill_window"] = self.prefill_window
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
                # later request's [0, cur_len] mask.
                err = e if isinstance(e, MXNetError) else ServeError(
                    f"engine step failed: {type(e).__name__}: {e}")
                with self._cv:
                    doomed = (list(self._running.values())
                              + list(self._prefilling.values()))
                    self._running.clear()
                    self._prefilling.clear()
                for req in doomed:
                    if req.slot is not None:
                        self.pool.free(req.slot)
                    _fail(req, err)
                self._count("errors", len(doomed))

    def _admit_locked(self):
        """Deadline-aware admission (runs under self._cv): drop expired
        waiters from the queue, then grant free slots
        earliest-deadline-first within the prefill token budget. A
        waiter's cost is the tokens its first wave processes, capped at
        one window; chunks already streaming bill the budget first; a
        waiter over budget is skipped so a cheaper one may fit. Returns
        (admitted, expired); the caller resolves expired futures
        off-lock."""
        now = time.perf_counter()
        expired = [r for r in self._waiting
                   if r.deadline is not None and now > r.deadline]
        if expired:
            dropset = set(id(r) for r in expired)
            self._waiting = deque(r for r in self._waiting
                                  if id(r) not in dropset)
        admitted = []
        budget = self.prefill_budget
        for req in self._prefilling.values():
            budget -= min(self.prefill_window,
                          int(req.prompt.size) - req.prefill_pos)
        free = self.pool.free_count()
        if free and self._waiting:
            ranked = sorted(
                self._waiting,
                key=lambda r: r.sort_key()[:2] + (
                    min(int(r.prompt.size), self.prefill_window),
                    r.t_submit))
            for req in ranked:
                if not free or len(admitted) >= self.prefill_lanes:
                    break
                cost = min(int(req.prompt.size), self.prefill_window)
                if admitted and budget - cost < 0:
                    continue    # over budget; a cheaper waiter may fit
                try:
                    req.slot = self.pool.claim()
                except SlotsFullError:   # raced a direct claim
                    break
                free -= 1
                budget -= cost
                admitted.append(req)
            if admitted:
                dropset = set(id(r) for r in admitted)
                self._waiting = deque(r for r in self._waiting
                                      if id(r) not in dropset)
        for req in admitted:
            self._prefilling[req.slot] = req
        return admitted, expired

    def _run_prefill(self, admitted):
        """One prefill wave: the windowed program for the admitted
        requests (page offset 0), then ONE chunk dispatch advancing EVERY
        lane whose prompt is still streaming. A request emits its first
        token the wave its prefill completes."""
        W = self.prefill_window
        g = self.pool.garbage_row
        params = self.model.params
        kb, vb = self.pool.buffers()
        n_tokens = 0
        finished = []                        # (req, first token)
        if admitted:
            P = self.prefill_lanes
            toks = _np.zeros((P, W), dtype=_np.int32)
            lens = _np.ones((P,), dtype=_np.int32)
            rows = _np.full((P,), g, dtype=_np.int32)
            for i, req in enumerate(admitted):
                head = min(int(req.prompt.size), W)
                toks[i, :head] = req.prompt[:head]
                lens[i] = head
                rows[i] = req.slot
            logits = self._prefill_prog(
                params, kb, vb, self._tensor(toks), self._tensor(lens),
                self._tensor(rows))
            first_host = _greedy(logits).cpu().numpy()
            for i, req in enumerate(admitted):
                head = min(int(req.prompt.size), W)
                req.prefill_pos = head
                n_tokens += head
                if head == req.prompt.size:
                    finished.append((req, int(first_host[i])))
        # chunk wave: long prompts mid-stream advance one window — ONE
        # dispatch at pool width; lanes with no chunk work write garbage
        with self._cv:
            pre = [self._prefilling[s] for s in sorted(self._prefilling)]
        fresh = set(id(r) for r in admitted)
        chunkers = [r for r in pre
                    if id(r) not in fresh
                    and r.prefill_pos < int(r.prompt.size)]
        if chunkers:
            S = self.pool.max_slots
            ctoks = _np.zeros((S, W), dtype=_np.int32)
            offs = _np.zeros((S,), dtype=_np.int32)
            nval = _np.zeros((S,), dtype=_np.int32)
            for req in chunkers:
                s = req.slot
                n = min(W, int(req.prompt.size) - req.prefill_pos)
                ctoks[s, :n] = req.prompt[req.prefill_pos:
                                          req.prefill_pos + n]
                offs[s] = req.prefill_pos
                nval[s] = n
            # smallest extent covering the furthest lane
            need = int((offs + nval).max())
            ext = next(x for x in self._chunk_extents if x >= need)
            logits = self._chunk_progs[ext](
                params, kb, vb, self._tensor(ctoks), self._tensor(offs),
                self._tensor(nval))
            first_host = _greedy(logits).cpu().numpy()
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
        if admitted or chunkers:
            self._count("prefill_batches")
        if n_tokens:
            self._count("prefill_tokens", n_tokens)
        done = []
        for req, tok in finished:
            req.cache_len = int(req.prompt.size)
            req.generated.append(tok)
            req.t_first = req.t_last = now
            with self._mlock:
                self._ttft_ms.append((now - req.t_submit) * 1e3)
            if self._finished(req):
                done.append(req)
        with self._cv:
            for req, _ in finished:
                self._prefilling.pop(req.slot, None)
                self._running[req.slot] = req
        self._retire(done)

    def _run_decode(self):
        """ONE decode wave: every active slot advances up to
        `decode_steps` tokens. Lanes are ALL pool rows (lane index == slab
        row); non-decoding lanes are inactive and write into the garbage
        row."""
        S = self.pool.max_slots
        toks = _np.zeros((S,), dtype=_np.int32)
        lens = _np.zeros((S,), dtype=_np.int32)
        left = _np.zeros((S,), dtype=_np.int32)
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
        kb, vb = self.pool.buffers()
        out_toks, emitted = self._decode_prog(
            self.model.params, kb, vb, self._tensor(toks),
            self._tensor(lens), self._tensor(left))
        out_host = out_toks.cpu().numpy()         # (decode_steps, S)
        emitted_host = emitted.cpu().numpy()
        now = time.perf_counter()
        n_tokens = 0
        done = []
        for slot, req in running.items():
            n_new = int(emitted_host[slot])
            if n_new > 0:
                req.generated.extend(int(t) for t in out_host[:n_new, slot])
                req.cache_len += n_new
                req.t_last = now
                n_tokens += n_new
            if self._finished(req):
                done.append(req)
        self._count("decode_iterations")
        self._count("decode_tokens", n_tokens)
        self._count("active_sum", len(running))
        self._retire(done)

    def _finished(self, req):
        if len(req.generated) >= req.max_new:
            return True
        if self.eos_id is not None and req.generated[-1] == self.eos_id:
            return True
        # page full: the NEXT decode would write past the slot
        return req.cache_len + 1 >= self.max_len

    def _retire(self, done):
        """Free slots and resolve futures."""
        for req in done:
            with self._cv:
                self._running.pop(req.slot, None)
            self.pool.free(req.slot)
            out = _np.asarray(req.generated, dtype=_np.int32)
            if self.eos_id is not None:
                hits = _np.nonzero(out == self.eos_id)[0]
                if hits.size:
                    out = out[:int(hits[0]) + 1]
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(out)
            now = time.perf_counter()
            with self._mlock:
                self._e2e_ms.append((now - req.t_submit) * 1e3)
                if len(req.generated) > 1 and req.t_first is not None:
                    self._tpot_ms.append(
                        (req.t_last - req.t_first) * 1e3
                        / (len(req.generated) - 1))
            self._count("replies")
            self._count("retired")


# engine counter -> process-wide SERVE_STATS key
_ENGINE_TO_SERVE_KEY = {
    "requests": "requests", "replies": "replies",
    "rejected": "rejected", "timeouts": "timeouts", "errors": "errors",
    "decode_iterations": "decode_iterations",
    "decode_tokens": "decode_tokens",
    "prefill_tokens": "decode_prefill_tokens",
    "admitted": "decode_admitted",
    "retired": "decode_retired",
}
