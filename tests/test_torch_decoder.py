"""PyTorch port: the cached-KV decoder (`serve.continuous.CachedDecoder`)
against the JAX package's, from the same numpy weights.

The port's prefill, chunk-prefill and decode steps must produce the JAX
programs' logits and KV (float32 on the CPU on both sides: only the
summation order of the matrix products differs, hence atol 1e-4), and
`reference_generate` must emit the JAX reference's greedy tokens exactly,
for windowed and chunked prompts and with `eos_id`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu_torch import MXNetError, serve
from torch_port_utils import CFG, decoders, numpy_params

torch.set_num_threads(1)

ATOL = 1e-4
W = 16


@pytest.fixture(scope="module")
def pair():
    return decoders()


def _pools(jm, tm, slots):
    jk, jv = jm.new_pool(max_slots=slots).buffers()
    tpool = tm.new_pool(max_slots=slots)
    return jk, jv, tpool


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=ATOL)


def _prefill_both(jm, tm, slots=3):
    """A windowed prefill wave with a full, a short and a garbage lane."""
    rng = np.random.RandomState(0)
    toks = rng.randint(1, CFG["vocab"], size=(3, W)).astype(np.int32)
    lens = np.array([W, 5, 1], np.int32)
    rows = np.array([0, 2, slots], np.int32)          # slots = garbage row
    jk, jv, tpool = _pools(jm, tm, slots)
    jk, jv, jlog = jm.prefill_program(W)(
        jm.params, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(rows))
    tlog = tm.prefill_program(W)(
        tm.params, tpool.k, tpool.v, torch.from_numpy(toks),
        torch.from_numpy(lens), torch.from_numpy(rows))
    return jk, jv, jlog, tpool, tlog


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
def test_reference_generate_refuses_unported_modes(pair, kw):
    _, tm = pair
    with pytest.raises(serve.ServeError, match="not ported"):
        tm.reference_generate([1, 2, 3, 4], 4, window=W, **kw)


def test_decoder_defaults_to_cuda():
    cfg = serve.DecoderConfig(**CFG)
    if torch.cuda.is_available():
        assert serve.CachedDecoder(cfg).device.type == "cuda"
        return
    with pytest.raises(MXNetError, match="cuda"):
        serve.CachedDecoder(cfg)
