"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py): one
set of decoder weights, made with numpy from a seed, handed to both the
JAX package and the port.

The weight scales differ from `init_decoder_params` on purpose: with the
default init a small random decoder just repeats the prompt's last token,
which would make token-exact comparisons say little. These scales give
varied greedy streams.
"""
import numpy as np

CFG = dict(vocab=64, embed=32, layers=2, heads=4, head_dim=8, max_len=48)


def numpy_params(cfg=CFG, seed=0):
    """Decoder params in the packages' layer-stacked layout, float32."""
    rng = np.random.RandomState(seed)
    E, L, V = cfg["embed"], cfg["layers"], cfg["vocab"]
    M = cfg.get("mlp_hidden", 4 * E)

    def rnd(shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    out = {"emb": rnd((V, E), 0.1), "pos": rnd((cfg["max_len"], E), 0.5)}
    for name in ("wq", "wk", "wv", "wo"):
        out[name] = rnd((L, E, E), 3.0 / np.sqrt(E))
    out["w1"] = rnd((L, E, M), 3.0 / np.sqrt(E))
    out["w2"] = rnd((L, M, E), 3.0 / np.sqrt(M))
    out["ln1"] = np.ones((L, E), np.float32)
    out["ln2"] = np.ones((L, E), np.float32)
    out["lnf"] = np.ones((E,), np.float32)
    return out


def decoders(cfg=CFG, seed=0):
    """(JAX CachedDecoder, port CachedDecoder on the CPU) over the same
    weights."""
    import jax.numpy as jnp
    from incubator_mxnet_tpu import serve as jserve
    from incubator_mxnet_tpu_torch import serve as tserve
    pn = numpy_params(cfg, seed)
    jm = jserve.CachedDecoder(jserve.DecoderConfig(**cfg),
                              params={k: jnp.asarray(v)
                                      for k, v in pn.items()})
    tm = tserve.CachedDecoder(tserve.DecoderConfig(**cfg),
                              params=tserve.params_from_jax(pn, "cpu"),
                              device="cpu")
    return jm, tm
