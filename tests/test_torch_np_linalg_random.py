"""PyTorch port: `mx.np.linalg` against the JAX package's, and
`mx.np.random`'s samplers (shapes, dtypes, seed reproducibility, moments).

linalg: the same float32 numpy inputs through both packages, within rtol
1e-4 / atol 1e-4 (LAPACK routines in another order); decompositions that
are unique only up to signs (qr, svd, eig*, gelqf, syevd) are held through
what they reconstruct. random: the port's draws come from its own
generator (ROADMAP §C), so each sampler is held to its distribution: the
mean within 5 standard errors over 20000 draws (and the variance within
10% where it is finite).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from torch_port_utils import assert_parity, to_jax_args, to_port_args

torch.set_num_threads(1)

CPU = tmx.cpu()
R = np.random.RandomState(0)
SPD = R.randn(4, 4).astype(np.float32)
SPD = (SPD @ SPD.T + 4 * np.eye(4)).astype(np.float32)
SQ = (R.randn(4, 4) + 3 * np.eye(4)).astype(np.float32)
RECT = R.randn(5, 3).astype(np.float32)
VEC = R.randn(4).astype(np.float32)
TOL = dict(rtol=1e-4, atol=1e-4)

CASES = {
    "norm": ((SQ,), {}), "det": ((SQ,), {}), "slogdet": ((SQ,), {}),
    "inv": ((SQ,), {}), "pinv": ((RECT,), {}), "solve": ((SQ, VEC), {}),
    "matrix_rank": ((RECT,), {}), "matrix_power": ((SQ, 3), {}),
    "cholesky": ((SPD,), {}), "svdvals": ((RECT,), {}),
    "eigvalsh": ((SPD,), {}), "multi_dot": (([SQ, SQ, RECT[:4]],), {}),
    "tensorinv": ((SQ,), {"ind": 1}), "tensorsolve": ((SQ, VEC), {}),
    "cond": ((SQ,), {}), "cross": ((RECT[:, :3], RECT[::-1, :3].copy()), {}),
    "outer": ((VEC, VEC), {}), "matmul": ((SQ, RECT[:4]), {}),
    "tensordot": ((SQ, SQ), {"axes": 1}),
    "vector_norm": ((RECT,), {"axis": 1}), "matrix_norm": ((RECT,), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_linalg_name_matches_jax(name):
    args, kw = CASES[name]
    want = getattr(jmx.np.linalg, name)(*to_jax_args(args), **kw)
    got = getattr(tmx.np.linalg, name)(*to_port_args(args), **kw)
    assert_parity(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(axis=0), dict(ord=1, axis=1),
                                dict(ord="fro"), dict(keepdims=True)])
def test_norm_options_match_jax(kw):
    assert_parity(tmx.np.linalg.norm(tmx.np.array(RECT, device=CPU), **kw),
                  jmx.np.linalg.norm(jmx.np.array(RECT), **kw), **TOL)


def _np(x):
    return x.asnumpy().astype(np.float64)


def test_decompositions_reconstruct_as_jax():
    t = tmx.np.array(RECT, device=CPU)
    q, r = tmx.np.linalg.qr(t)
    jq, jr = jmx.np.linalg.qr(jmx.np.array(RECT))
    assert q.shape == jq.shape and r.shape == jr.shape
    np.testing.assert_allclose(_np(q) @ _np(r), RECT, **TOL)
    u, s, vt = tmx.np.linalg.svd(t, full_matrices=False)
    ju, js, jvt = jmx.np.linalg.svd(jmx.np.array(RECT), full_matrices=False)
    assert_parity(s, js, **TOL)
    np.testing.assert_allclose(_np(u) * _np(s) @ _np(vt), RECT, **TOL)
    w, v = tmx.np.linalg.eigh(tmx.np.array(SPD, device=CPU))
    jw, jv = jmx.np.linalg.eigh(jmx.np.array(SPD))
    assert_parity(w, jw, **TOL)
    np.testing.assert_allclose(_np(v) @ np.diag(_np(w)) @ _np(v).T, SPD,
                               **TOL)
    ev = tmx.np.linalg.eigvals(tmx.np.array(SPD, device=CPU))
    np.testing.assert_allclose(np.sort(ev.asnumpy().real),
                               np.sort(_np(jw)), **TOL)
    ew, evec = tmx.np.linalg.eig(tmx.np.array(SPD, device=CPU))
    np.testing.assert_allclose(
        (evec.asnumpy() @ np.diag(ew.asnumpy()) @ np.linalg.inv(
            evec.asnumpy())).real, SPD, **TOL)
    sol, res, rank, sv = tmx.np.linalg.lstsq(
        t, tmx.np.array(RECT[:, 0].copy(), device=CPU))
    jsol = jmx.np.linalg.lstsq(jmx.np.array(RECT),
                               jmx.np.array(RECT[:, 0].copy()))
    assert_parity(sol, jsol[0], **TOL)
    assert int(rank.item()) == int(jsol[2].item())


@pytest.mark.parametrize("name,args,kw", [
    ("syrk", (RECT,), {}), ("syrk", (RECT,), {"transpose": True,
                                             "alpha": 0.5}),
    ("trmm", (SQ, RECT[:4]), {}),
    ("trmm", (SQ, RECT[:4].T.copy()), {"rightside": True,
                                       "transpose": True, "lower": False}),
    ("trsm", (SQ, RECT[:4]), {}),
    ("trsm", (SQ, RECT[:4].T.copy()), {"rightside": True, "alpha": 2.0}),
    ("trsm", (SQ, RECT[:4]), {"transpose": True, "lower": False}),
    ("potrf", (SPD,), {}), ("potrf", (SPD,), {"lower": False}),
    ("potri", (np.linalg.cholesky(SPD).astype(np.float32),), {}),
    ("gemm2", (SQ, RECT[:4]), {"transpose_a": True, "alpha": 3.0}),
])
def test_la_ops_match_jax(name, args, kw):
    want = getattr(jmx.np.linalg, name)(*to_jax_args(args), **kw)
    got = getattr(tmx.np.linalg, name)(*to_port_args(args), **kw)
    assert_parity(got, want, **TOL)


def test_gelqf_and_syevd_reconstruct():
    L, Q = tmx.np.linalg.gelqf(tmx.np.array(RECT.T.copy(), device=CPU))
    np.testing.assert_allclose(_np(L) @ _np(Q), RECT.T, **TOL)
    np.testing.assert_allclose(_np(Q) @ _np(Q).T, np.eye(3), **TOL)
    U, lam = tmx.np.linalg.syevd(tmx.np.array(SPD, device=CPU))
    jU, jlam = jmx.np.linalg.syevd(jmx.np.array(SPD))
    assert_parity(lam, jlam, **TOL)
    np.testing.assert_allclose(_np(U).T @ np.diag(_np(lam)) @ _np(U), SPD,
                               **TOL)


def test_linalg_exports_match_jax():
    assert set(jmx.np.linalg.__all__) <= set(tmx.np.linalg.__all__)


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------
N = 20000

# name -> (args, kwargs, mean, variance or None, dtype)
SAMPLERS = {
    "uniform": ((-1.0, 3.0), {}, 1.0, 16 / 12, "float32"),
    "normal": ((1.0, 2.0), {}, 1.0, 4.0, "float32"),
    "lognormal": ((0.0, 0.5), {}, np.exp(0.125),
                  (np.exp(0.25) - 1) * np.exp(0.25), "float32"),
    "gamma": ((2.0, 1.5), {}, 3.0, 4.5, "float32"),
    "beta": ((2.0, 3.0), {}, 0.4, 0.04, "float32"),
    "exponential": ((2.0,), {}, 2.0, 4.0, "float32"),
    "poisson": ((3.0,), {}, 3.0, 3.0, "int32"),
    "laplace": ((1.0, 2.0), {}, 1.0, 8.0, "float32"),
    "gumbel": ((0.0, 1.0), {}, 0.5772156649, np.pi ** 2 / 6, "float32"),
    "logistic": ((0.0, 1.0), {}, 0.0, np.pi ** 2 / 3, "float32"),
    "pareto": ((5.0,), {}, 0.25, 5 / (16 * 3), "float32"),
    "power": ((3.0,), {}, 0.75, 3 / 80, "float32"),
    "rayleigh": ((2.0,), {}, 2.0 * np.sqrt(np.pi / 2),
                 (4 - np.pi) / 2 * 4, "float32"),
    "weibull": ((2.0,), {}, 0.8862269, 1 - np.pi / 4, "float32"),
    "chisquare": ((3.0,), {}, 3.0, 6.0, "float32"),
    "bernoulli": ((0.3,), {}, 0.3, 0.21, "float32"),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_moments_shape_dtype_and_seed(name):
    args, kw, mean, var, dtype = SAMPLERS[name]
    fn = getattr(tmx.np.random, name)
    with tmx.cpu():
        tmx.seed(7)
        x = fn(*args, size=(N,), **kw)
        tmx.np.random.seed(7)
        y = fn(*args, size=(N,), **kw)
        z = fn(*args, size=(N,), **kw)
    jx = getattr(jmx.np.random, name)(*args, size=(4,), **kw)
    assert x.shape == (N,) and str(x.dtype) == str(jx.dtype) == dtype
    np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
    assert not np.array_equal(x.asnumpy(), z.asnumpy())
    v = x.asnumpy().astype(np.float64)
    assert abs(v.mean() - mean) < 5 * np.sqrt(var / N), (v.mean(), mean)
    assert abs(v.var() - var) < 0.1 * var, (v.var(), var)


def test_discrete_samplers():
    with tmx.cpu():
        tmx.seed(0)
        r = tmx.np.random.randint(2, 9, size=(N,))
        assert str(r.dtype) == str(jmx.np.random.randint(2, 9, (3,)).dtype)
        counts = np.bincount(r.asnumpy(), minlength=9)[2:]
        exp = N / 7
        assert ((counts - exp) ** 2 / exp).sum() < 30   # chi-square, 6 dof
        c = tmx.np.random.choice(5, size=(N,), p=[0.1, 0.2, 0.3, 0.2, 0.2])
        freq = np.bincount(c.asnumpy(), minlength=5) / N
        np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.2, 0.2],
                                   atol=0.015)
        perm = tmx.np.random.choice(10, size=(10,), replace=False)
        assert sorted(perm.asnumpy().tolist()) == list(range(10))
        p = tmx.np.random.permutation(8)
        assert sorted(p.asnumpy().tolist()) == list(range(8))
        assert str(p.dtype) == str(jmx.np.random.permutation(8).dtype)
        a = tmx.np.arange(12).reshape(6, 2)
        tmx.np.random.shuffle(a)
        assert sorted(a.asnumpy()[:, 0].tolist()) == list(range(0, 12, 2))
        m = tmx.np.random.multinomial(100, [0.2, 0.3, 0.5], size=(N // 10,))
        assert m.shape == (N // 10, 3)
        assert str(m.dtype) == str(jmx.np.random.multinomial(
            100, jmx.np.array([0.2, 0.3, 0.5])).dtype)
        np.testing.assert_allclose(m.asnumpy().mean(0), [20, 30, 50],
                                   atol=1.0)
        lg = np.log(np.array([0.1, 0.6, 0.3], np.float32))
        cat = tmx.np.random.categorical(tmx.np.array(lg), shape=(N,))
        np.testing.assert_allclose(np.bincount(cat.asnumpy()) / N,
                                   [0.1, 0.6, 0.3], atol=0.015)
        mvn = tmx.np.random.multivariate_normal(
            tmx.np.array([1.0, -1.0]), tmx.np.array([[2.0, 0.5], [0.5, 1.0]]),
            size=(N,))
        cov = np.cov(mvn.asnumpy().T)
        np.testing.assert_allclose(cov, [[2.0, 0.5], [0.5, 1.0]], atol=0.1)
        for f in (tmx.np.random.rand, tmx.np.random.randn):
            assert f(2, 3).shape == (2, 3) and f(2, 3).dtype == np.float32


def test_samples_are_differentiable_in_their_parameters():
    with tmx.cpu():
        loc = tmx.np.array([1.0, 2.0])
        scale = tmx.np.array([0.5, 3.0])
        loc.attach_grad()
        scale.attach_grad()
        with tmx.autograd.record():
            x = tmx.np.random.normal(loc, scale, size=(2,))
            x.sum().backward()
        np.testing.assert_allclose(loc.grad.asnumpy(), [1.0, 1.0])
        np.testing.assert_allclose(
            scale.grad.asnumpy(),
            (x.asnumpy() - loc.asnumpy()) / scale.asnumpy(), rtol=1e-5)


def test_random_exports_match_jax():
    assert set(jmx.np.random.__all__) <= set(tmx.np.random.__all__)
