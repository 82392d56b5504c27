"""PyTorch port: the cached-KV decoder (`serve.continuous.CachedDecoder`)
against the JAX package's, from the same numpy weights.

The port's prefill, chunk-prefill, decode and speculative steps must
produce the JAX programs' logits and KV (float32 on the CPU on both sides:
only the summation order of the matrix products differs, hence atol 1e-4),
on float, mixed-dtype and int8 pools (int8 codes exactly equal), and
`reference_generate` must emit the JAX reference's tokens exactly, for
windowed, chunked, int8, speculative and prefix-hit prompts and with
`eos_id`. Sampling is held against the JAX sampler by feeding both
packages one Gumbel noise table (the port's own noise is a counter-based
hash, not `jax.random`'s bits), and the port's noise by a chi-square test.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.serve import continuous as jcont
from incubator_mxnet_tpu_torch import MXNetError, serve
from incubator_mxnet_tpu_torch.serve import continuous as tcont
from torch_port_utils import CFG, decoders, numpy_params

torch.set_num_threads(1)

ATOL = 1e-4
W = 16


@pytest.fixture(scope="module")
def pair():
    return decoders()


# one Gumbel noise table, indexed by (request seed, position), that both
# packages' samplers draw from in the shared-noise tests
N_SEEDS = 8
NOISE = np.random.RandomState(7).gumbel(
    size=(N_SEEDS, CFG["max_len"], CFG["vocab"])).astype(np.float32)


@pytest.fixture
def shared_noise(monkeypatch):
    """(JAX decoder, port decoder) over the same weights whose samplers
    both add NOISE[seed, position] to the masked logits and take the
    argmax: `jax.random.fold_in`/`categorical` are patched in this test
    only (the JAX decoder and first-token sampler are fresh, so their
    programs trace the patched functions), the port's `_gumbel_noise`
    likewise."""
    import jax
    g = jnp.asarray(NOISE)
    monkeypatch.setattr(jax.random, "fold_in", lambda key, pos: jnp.stack(
        [key[1], jnp.asarray(pos).astype(jnp.uint32)]))
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits:
                        jnp.argmax(logits + g[key[0], key[1]], axis=-1))
    # a fresh function to jit: jax reuses a trace of `_sample_tokens`
    # itself made before the patch
    monkeypatch.setattr(jcont, "_SAMPLE_JIT", jax.jit(
        lambda *a: jcont._sample_tokens(*a)))
    gt = torch.from_numpy(NOISE)
    monkeypatch.setattr(tcont, "_gumbel_noise", lambda keys, pos, vocab:
                        gt[keys[:, 1].long(), pos.long()])
    return decoders()


def _pools(jm, tm, slots, dtype=None):
    jk, jv = jm.new_pool(max_slots=slots, dtype=dtype).buffers()
    tpool = tm.new_pool(max_slots=slots, dtype=dtype)
    return jk, jv, tpool


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=ATOL)


def _prefill_both(jm, tm, slots=3, dtype=None, toks=None):
    """A windowed prefill wave with a full, a short and a garbage lane."""
    rng = np.random.RandomState(0)
    if toks is None:
        toks = rng.randint(1, CFG["vocab"], size=(3, W)).astype(np.int32)
    lens = np.array([W, 5, 1], np.int32)
    rows = np.array([0, 2, slots], np.int32)          # slots = garbage row
    jk, jv, tpool = _pools(jm, tm, slots, dtype)
    jk, jv, jlog = jm.prefill_program(W)(
        jm.params, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(rows))
    tlog = tm.prefill_program(W)(
        tm.params, *tpool.buffers(), torch.from_numpy(toks),
        torch.from_numpy(lens), torch.from_numpy(rows))
    return jk, jv, jlog, tpool, tlog


def _slab_close(jcache, tcache, rows, upto):
    """The port's slab rows equal the JAX program's: float slabs within
    ATOL, int8 codes exactly and their scales within 1e-6 relative."""
    if isinstance(jcache, tuple):
        (jc, js), (tc, ts) = jcache, tcache
        for r in rows:
            np.testing.assert_array_equal(np.asarray(jc[r, :, :upto]),
                                          tc[r, :, :upto].numpy())
            np.testing.assert_allclose(np.asarray(js[r, :, :upto]),
                                       ts[r, :, :upto].numpy(), rtol=1e-6)
        return
    for r in rows:
        np.testing.assert_allclose(
            np.asarray(jcache[r, :, :upto]).astype(np.float32),
            tcache[r, :, :upto].float().numpy(), rtol=0, atol=ATOL)


def test_prefill_logits_and_kv_match_jax(pair):
    jm, tm = pair
    jk, jv, jlog, tpool, tlog = _prefill_both(jm, tm)
    _close(jlog, tlog)
    for row in (0, 2):
        _close(jk[row, :, :W], tpool.k[row, :, :W])
        _close(jv[row, :, :W], tpool.v[row, :, :W])


def test_chunk_prefill_logits_and_kv_match_jax(pair):
    """A chunk wave after the windowed head: lane 0 streams its second
    window, lane 1 a 3-token slice at offset 5, lane 2 idles; the read is
    bounded by an extent of two windows."""
    jm, tm = pair
    jk, jv, _, tpool, _ = _prefill_both(jm, tm)
    rng = np.random.RandomState(1)
    toks = rng.randint(1, CFG["vocab"], size=(3, W)).astype(np.int32)
    offs = np.array([W, 5, 0], np.int32)
    nval = np.array([W, 3, 0], np.int32)
    jk, jv, jlog = jm.chunk_prefill_program(W, extent=2 * W)(
        jm.params, jk, jv, jnp.asarray(toks), jnp.asarray(offs),
        jnp.asarray(nval))
    tlog = tm.chunk_prefill_program(W, extent=2 * W)(
        tm.params, tpool.k, tpool.v, torch.from_numpy(toks),
        torch.from_numpy(offs), torch.from_numpy(nval))
    _close(jlog[:2], tlog[:2])
    _close(jk[:3, :, :2 * W], tpool.k[:3, :, :2 * W])
    _close(jv[:3, :, :2 * W], tpool.v[:3, :, :2 * W])


@pytest.mark.parametrize("eos", [None, "mid"])
def test_decode_tokens_emitted_and_kv_match_jax(pair, eos):
    """A 4-step decode wave over every pool row: two live lanes with
    different budgets and an inactive one. With `eos` set to a token lane
    0 emits mid-wave, the lane stops there and `emitted` counts exactly."""
    jm, tm = pair
    jk, jv, jlog, tpool, tlog = _prefill_both(jm, tm)
    first = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    toks = np.array([first[0], 0, first[1]], np.int32)    # lanes = rows
    lens = np.array([W, 0, 5], np.int32)
    left = np.array([4, 0, 2], np.int32)
    eos_id = None
    if eos == "mid":
        _, _, probe, _ = jm.decode(jk, jv, jnp.asarray(toks),
                                   jnp.asarray(lens), jnp.asarray(left),
                                   steps=4)
        eos_id = int(np.asarray(probe)[1, 0])
        jk, jv, jlog, tpool, tlog = _prefill_both(jm, tm)
    jk, jv, jt, je = jm.decode(jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                               jnp.asarray(left), steps=4, eos_id=eos_id)
    tt, te = tm.decode(tpool.k, tpool.v, torch.from_numpy(toks),
                       torch.from_numpy(lens), torch.from_numpy(left),
                       steps=4, eos_id=eos_id)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    if eos == "mid":
        assert int(te[0]) < 4
    for row in (0, 2):
        _close(jk[row, :, :W + 4], tpool.k[row, :, :W + 4])
        _close(jv[row, :, :W + 4], tpool.v[row, :, :W + 4])


PROMPTS = [
    [7, 3, 19],                       # short, windowed
    list(range(1, W + 1)),            # exactly one window
    list(range(1, 40)),               # 3 chunks at window 16
    [40, 2, 33, 9, 12] * 5,           # 25 tokens: head + partial chunk
]


@pytest.mark.parametrize("prompt", PROMPTS, ids=lambda p: f"len{len(p)}")
def test_reference_generate_token_exact_vs_jax(pair, prompt):
    jm, tm = pair
    want = jm.reference_generate(prompt, 8, window=W)
    got = tm.reference_generate(prompt, 8, window=W)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_reference_generate_eos_and_page_full_vs_jax(pair):
    jm, tm = pair
    prompt = [1, 2, 3]
    base = jm.reference_generate(prompt, 16, window=W)
    eos = int(base[len(base) // 2])
    want = jm.reference_generate(prompt, 16, window=W, eos_id=eos)
    got = tm.reference_generate(prompt, 16, window=W, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == eos and len(got) < len(base)
    # page-limited: 40 prompt tokens leave room for 8 on a 48-slot page
    long = list(range(1, 41))
    np.testing.assert_array_equal(
        tm.reference_generate(long, 30, window=W),
        jm.reference_generate(long, 30, window=W))


def test_params_from_jax_layout_dtype_and_checks():
    pn = numpy_params()
    pt = serve.params_from_jax(pn, device="cpu")
    for k, a in pn.items():
        assert pt[k].dtype == torch.float32
        np.testing.assert_array_equal(pt[k].numpy(), a)
    # bfloat16 weights keep their bits
    cfg = jserve.DecoderConfig(**dict(CFG, dtype="bfloat16"))
    pj = {k: np.asarray(v) for k, v in
          jserve.init_decoder_params(cfg, seed=1).items()}
    pb = serve.params_from_jax(pj, device="cpu")
    assert pb["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pb["wq"].view(torch.int16).numpy(), pj["wq"].view(np.int16))
    with pytest.raises(serve.ServeError, match="exactly"):
        serve.params_from_jax({"emb": pn["emb"]}, device="cpu")


def test_init_decoder_params_seeded_and_shaped_like_jax():
    cfg = serve.DecoderConfig(**CFG)
    a = serve.init_decoder_params(cfg, seed=4, device="cpu")
    b = serve.init_decoder_params(cfg, seed=4, device="cpu")
    c = serve.init_decoder_params(cfg, seed=5, device="cpu")
    ref = jserve.init_decoder_params(jserve.DecoderConfig(**CFG), seed=4)
    assert set(a) == set(ref)
    for k in a:
        assert tuple(a[k].shape) == tuple(ref[k].shape)
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["wq"], c["wq"])
    with pytest.raises(serve.ServeError, match="heads"):
        serve.DecoderConfig(embed=32, heads=3, head_dim=8)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7), dict(top_k=5), dict(top_p=0.9),
    dict(draft_tokens=2), dict(kv_dtype="int8"), dict(cached_prefix_len=2)],
    ids=lambda kw: next(iter(kw)))
def test_reference_generate_refuses_unported_modes(shared_noise, kw):
    """Each mode the first slice refused now serves: the port's reference
    with that mode equals the JAX package's, token for token (a sampled
    mode with both packages drawing from one noise table), on a windowed
    and on a chunked prompt."""
    jm, tm = shared_noise
    for prompt in ([1, 2, 3, 4], list(range(1, 30))):
        kw2 = dict(kw)
        if "temperature" in kw:
            kw2["seed"] = 3
        want = jm.reference_generate(prompt, 8, window=W, **kw2)
        got = tm.reference_generate(prompt, 8, window=W, **kw2)
        np.testing.assert_array_equal(got, want, err_msg=str(kw2))


def test_decoder_defaults_to_cuda():
    cfg = serve.DecoderConfig(**CFG)
    if torch.cuda.is_available():
        assert serve.CachedDecoder(cfg).device.type == "cuda"
        return
    with pytest.raises(MXNetError, match="cuda"):
        serve.CachedDecoder(cfg)


# ---------------------------------------------------------------------------
# int8 and mixed-dtype pools, sampling, speculative decode, prefix hits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_and_scales_equal_jax(dtype):
    """Absmax over (heads, head_dim), round half to even: codes and scales
    exactly equal, including values that sit on a rounding tie."""
    import ml_dtypes
    rng = np.random.RandomState(5)
    val = (rng.randn(6, 5, 4, 8) * 3).astype(np.float32)
    val[0, 0, 0, :3] = [127.0, 63.5, -0.5]     # ties at scale 1
    val[0, 0, 1:] = 0.0
    if dtype == "bfloat16":
        jv = val.astype(ml_dtypes.bfloat16)
        tv = torch.from_numpy(val).bfloat16()
    else:
        jv, tv = val, torch.from_numpy(val)
    jq, js = jcont._quantize_kv(jnp.asarray(jv))
    tq, ts = tcont._quantize_kv(tv)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tq[0, 0, 0, :3].tolist() == [127, 64, 0]


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_programs_on_int8_and_mixed_pools_match_jax(pair, kv):
    """A float32 model over an int8 pool (codes + scales) and over a
    bfloat16 pool: the prefill (in-page attention on unquantized K/V),
    a chunk wave (reads dequantize what was just written) and a 3-step
    decode wave give the JAX programs' logits, slab contents and tokens."""
    jm, tm = pair
    jk, jv, jlog, tpool, tlog = _prefill_both(jm, tm, dtype=kv)
    _close(jlog, tlog)
    tk, tv = tpool.buffers()
    _slab_close(jk, tk, (0, 2), W)
    _slab_close(jv, tv, (0, 2), W)
    rng = np.random.RandomState(1)
    toks = rng.randint(1, CFG["vocab"], size=(3, W)).astype(np.int32)
    offs = np.array([W, 5, 0], np.int32)
    nval = np.array([W, 3, 0], np.int32)
    jk, jv, jclog = jm.chunk_prefill_program(W, extent=2 * W)(
        jm.params, jk, jv, jnp.asarray(toks), jnp.asarray(offs),
        jnp.asarray(nval))
    tclog = tm.chunk_prefill_program(W, extent=2 * W)(
        tm.params, tk, tv, torch.from_numpy(toks), torch.from_numpy(offs),
        torch.from_numpy(nval))
    _close(jclog[:2], tclog[:2])
    _slab_close(jk, tk, (0, 1), 2 * W)
    first = np.argmax(np.asarray(jclog), axis=-1).astype(np.int32)
    dtoks = np.array([first[0], first[1], 0], np.int32)
    lens = np.array([2 * W, 8, 0], np.int32)
    left = np.array([3, 2, 0], np.int32)
    jk, jv, jt, je = jm.decode(jk, jv, jnp.asarray(dtoks),
                               jnp.asarray(lens), jnp.asarray(left), steps=3)
    tt, te = tm.decode(tk, tv, torch.from_numpy(dtoks),
                       torch.from_numpy(lens), torch.from_numpy(left),
                       steps=3)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    _slab_close(jk, tk, (0, 1), 2 * W + 3)
    _slab_close(jv, tv, (0, 1), 2 * W + 3)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_spec_program_matches_jax(pair, kv):
    """Two speculative micro-steps (draft 2, C = 3 queries through the
    paged attention) over two live lanes with repetitive histories and an
    idle one: the base model's choices, emit counts, accepted and rejected
    drafts, and the slab equal the JAX program's."""
    jm, tm = pair
    toks = np.tile(np.array([5, 9, 13, 5], np.int32), (3, 4))
    jk, jv, jlog, tpool, tlog = _prefill_both(jm, tm, dtype=kv, toks=toks)
    first = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    lens = np.array([W, 0, 5], np.int32)
    left = np.array([7, 0, 4], np.int32)
    dtoks = np.array([first[0], 0, first[1]], np.int32)
    buf = np.zeros((3, CFG["max_len"]), np.int32)
    buf[0, :W], buf[0, W] = toks[0], first[0]
    buf[2, :5], buf[2, 5] = toks[1, :5], first[1]
    out = jm.decode(jk, jv, jnp.asarray(dtoks), jnp.asarray(lens),
                    jnp.asarray(left), steps=2, draft=2,
                    token_buf=jnp.asarray(buf))
    jk, jv = out[0], out[1]
    want = [np.asarray(a) for a in out[2:]]
    tk, tv = tpool.buffers()
    got = [a.numpy() for a in tm.decode(
        tk, tv, torch.from_numpy(dtoks), torch.from_numpy(lens),
        torch.from_numpy(left), steps=2, draft=2,
        token_buf=torch.from_numpy(buf))]
    for name, a, b in zip(("n_emits", "emitted", "accepted", "rejected"),
                          want[1:], got[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(want[0][:, [0, 2]], got[0][:, [0, 2]])
    assert got[2][0] + got[3][0] > 0 and got[2][1] == 0
    _slab_close(jk, tk, (0, 2), W + 7)


def test_sample_tokens_equal_jax_with_shared_noise(monkeypatch):
    """The port's `_sample_tokens` against the JAX package's on the same
    logits and the same Gumbel noise (JAX's fold_in/categorical patched in
    this test to argmax(logits + G[lane, position])): temperature, top-k,
    top-p, their mix and greedy lanes, token for token."""
    import jax
    rng = np.random.RandomState(11)
    n, V, T = 12, 40, 16
    logits = (rng.randn(n, V) * 2).astype(np.float32)
    g = rng.gumbel(size=(n, T, V)).astype(np.float32)
    temps = np.array([0, 0.5, 1, 2, 1, 1, 0.8, 0.8, 3, 1, 0, 1], np.float32)
    tks = np.array([0, 0, 5, 0, 1, 3, 10, 0, 2, 40, 4, 0], np.int32)
    tps = np.array([1, 1, 1, 0.5, 1, 0.9, 0.6, 0.3, 1, 1, 0.5, 1e-6],
                   np.float32)
    pos = rng.randint(0, T, n).astype(np.int32)
    keys = np.stack([np.zeros(n), np.arange(n)], 1).astype(np.uint32)
    gj = jnp.asarray(g)
    monkeypatch.setattr(jax.random, "fold_in", lambda key, p: jnp.stack(
        [key[1], jnp.asarray(p).astype(jnp.uint32)]))
    monkeypatch.setattr(jax.random, "categorical", lambda key, lg:
                        jnp.argmax(lg + gj[key[0], key[1]], axis=-1))
    want = np.asarray(jcont._sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tks),
        jnp.asarray(tps), jnp.asarray(keys), jnp.asarray(pos)))
    got = tcont._sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(tks), torch.from_numpy(tps),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(pos),
        noise=torch.from_numpy(g[np.arange(n), pos]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[temps == 0] == logits[temps == 0].argmax(-1)).all()


def test_sample_tokens_distribution_chi_square():
    """The port's own noise: 20k draws from fixed logits land on the known
    distribution (chi-square, df 7), greedy lanes return argmax, top-k and
    top-p truncate the support exactly (tests/test_decode.py's check)."""
    probs = np.array([0.4, 0.3, 0.1, 0.1, 0.05, 0.03, 0.01, 0.01])
    n = 20000
    logits = torch.from_numpy(np.tile(np.log(probs), (n, 1))).float()
    keys = torch.from_numpy(np.tile(tcont._seed_key(123), (n, 1)))
    positions = torch.arange(n, dtype=torch.int32)
    ones = torch.ones(n)
    zeros_i = torch.zeros(n, dtype=torch.int32)
    draws = tcont._sample_tokens(logits, ones, zeros_i, ones, keys,
                                 positions).numpy()
    counts = np.bincount(draws, minlength=len(probs))
    chi2 = float(np.sum((counts - n * probs) ** 2 / (n * probs)))
    assert chi2 < 30.0, f"chi2={chi2:.2f} counts={counts.tolist()}"
    greedy = tcont._sample_tokens(logits, torch.zeros(n), zeros_i, ones,
                                  keys, positions)
    assert (greedy.numpy() == int(np.argmax(probs))).all()
    topk = tcont._sample_tokens(logits, ones, torch.full((n,), 2), ones,
                                keys, positions)
    assert set(np.unique(topk.numpy())) == {0, 1}
    topp = tcont._sample_tokens(logits, ones, zeros_i,
                                torch.full((n,), 0.69), keys, positions)
    assert set(np.unique(topp.numpy())) == {0, 1}


def test_gumbel_noise_is_a_function_of_key_position_and_index():
    keys = torch.from_numpy(np.stack([tcont._seed_key(s) for s in
                                      (0, 1, 1, 2 ** 40)]))
    pos = torch.tensor([5, 5, 6, 5])
    a = tcont._gumbel_noise(keys, pos, 64)
    b = tcont._gumbel_noise(keys[[1, 0]], pos[[1, 0]], 64)
    assert torch.equal(a[[1, 0]], b)            # per row, not per batch
    assert torch.isfinite(a).all() and a.dtype == torch.float32
    for i, j in ((0, 1), (1, 2), (0, 3)):       # seed, position, high word
        assert not torch.equal(a[i], a[j])


def test_seed_determinism_and_divergence(pair):
    _, tm = pair
    prompt, m = [9, 4, 33, 2], 12
    a = tm.reference_generate(prompt, m, temperature=8.0, seed=7)
    b = tm.reference_generate(prompt, m, temperature=8.0, seed=7)
    np.testing.assert_array_equal(a, b)
    outs = {tuple(tm.reference_generate(prompt, m, temperature=8.0,
                                        seed=s).tolist())
            for s in range(10)}
    assert len(outs) >= 4, f"only {len(outs)} distinct outputs at T=8"


@pytest.mark.parametrize("kv", [None, "int8"])
def test_spec_reference_matches_plain_reference(pair, kv):
    """Speculation changes no token: greedy and sampled, on float and int8
    pools, and equal to the JAX reference for the greedy ones."""
    jm, tm = pair
    for prompt in ([7, 3, 19], [5, 9, 5, 9, 5, 9, 5], list(range(1, 30))):
        for samp in ({}, dict(temperature=0.9, top_k=10, seed=2)):
            plain = tm.reference_generate(prompt, 10, window=W,
                                          kv_dtype=kv, **samp)
            for k in (1, 3):
                np.testing.assert_array_equal(
                    plain, tm.reference_generate(
                        prompt, 10, window=W, kv_dtype=kv, draft_tokens=k,
                        **samp), err_msg=f"draft={k} {samp} {prompt}")
        np.testing.assert_array_equal(
            tm.reference_generate(prompt, 10, window=W, kv_dtype=kv),
            jm.reference_generate(prompt, 10, window=W, kv_dtype=kv))


def test_spec_reference_eos_inside_draft_block(pair):
    jm, tm = pair
    prompt, max_new = [7, 3, 19], 16
    base = tm.reference_generate(prompt, max_new)
    eos = int(base[len(base) // 2])
    expect = jm.reference_generate(prompt, max_new, eos_id=eos)
    assert len(expect) < len(base)
    for k in (1, 2):
        np.testing.assert_array_equal(
            tm.reference_generate(prompt, max_new, eos_id=eos,
                                  draft_tokens=k), expect)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefix_hit_reference_matches_jax(pair, kv):
    """`cached_prefix_len`: the head stops at the cache boundary and the
    suffix goes through the chunk program, on a float and an int8 pool."""
    jm, tm = pair
    prompt = list(range(2, 30))
    for L in (8, 16, 24):
        np.testing.assert_array_equal(
            tm.reference_generate(prompt, 8, window=W, kv_dtype=kv,
                                  cached_prefix_len=L),
            jm.reference_generate(prompt, 8, window=W, kv_dtype=kv,
                                  cached_prefix_len=L), err_msg=f"L={L}")
    with pytest.raises(serve.ServeError, match="cached_prefix_len"):
        tm.reference_generate(prompt, 4, cached_prefix_len=len(prompt))


def test_copy_program_moves_codes_and_scales_like_jax(pair):
    """The prefix cache's row copy, on an int8 pool: whole rows of codes
    AND scales land in place, as the JAX package's `_copy_slot_rows`
    moves them."""
    jm, tm = pair
    rng = np.random.RandomState(12)
    shape = (5, CFG["layers"], CFG["max_len"], CFG["heads"],
             CFG["head_dim"])
    codes = rng.randint(-127, 128, (2,) + shape).astype(np.int8)
    scales = rng.rand(2, *shape[:3]).astype(np.float32)
    src, dst = np.array([3, 0], np.int32), np.array([1, 4], np.int32)
    jk, jv = jcont._copy_slot_rows(
        (jnp.asarray(codes[0]), jnp.asarray(scales[0])),
        (jnp.asarray(codes[1]), jnp.asarray(scales[1])),
        jnp.asarray(src), jnp.asarray(dst))
    tk = (torch.from_numpy(codes[0].copy()), torch.from_numpy(scales[0]))
    tv = (torch.from_numpy(codes[1].copy()), torch.from_numpy(scales[1]))
    tm.copy_program()(tk, tv, torch.from_numpy(src).long(),
                      torch.from_numpy(dst).long())
    for j, t in zip(jk + jv, tk + tv):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert not np.array_equal(codes[0][1], tk[0][1].numpy())


def test_prefill_method_draws_first_tokens(pair):
    """`CachedDecoder.prefill` returns greedy first tokens by default and
    the sampler's draw at position lengths - 1 for a sampled lane."""
    jm, tm = pair
    rng = np.random.RandomState(13)
    toks = torch.from_numpy(rng.randint(1, CFG["vocab"], (2, W)).astype(
        np.int32))
    lens = torch.tensor([W, 4], dtype=torch.int32)
    rows = torch.tensor([0, 1], dtype=torch.int32)
    pool = tm.new_pool(max_slots=2)
    greedy = tm.prefill(*pool.buffers(), toks, lens, rows)
    logits = tm.prefill_program(W)(tm.params, *pool.buffers(), toks, lens,
                                   rows)
    np.testing.assert_array_equal(greedy, logits.argmax(-1).numpy())
    keys = np.stack([tcont._seed_key(5), tcont._seed_key(6)])
    samp = dict(temps=np.array([0.0, 1.5], np.float32),
                top_ks=np.zeros(2, np.int64),
                top_ps=np.ones(2, np.float32), keys=keys)
    drawn = tm.prefill(*pool.buffers(), toks, lens, rows, **samp)
    assert drawn[0] == greedy[0]
    want = tcont._sample_tokens(
        logits, torch.from_numpy(samp["temps"]),
        torch.from_numpy(samp["top_ks"]), torch.from_numpy(samp["top_ps"]),
        torch.from_numpy(keys), lens - 1)
    np.testing.assert_array_equal(drawn, want.numpy())
