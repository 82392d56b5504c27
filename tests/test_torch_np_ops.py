"""PyTorch port: every name of `mx.np` against the JAX package's.

One parametrised case a name (a few names also with int inputs): the same
numpy inputs, made from a seed, go through `incubator_mxnet_tpu.numpy`
and `incubator_mxnet_tpu_torch.numpy` on the CPU, and the results must
have the same structure, shapes and dtype names, and values within
`torch_port_utils.PARITY_TOL` (float32: rtol 1e-5, atol 1e-6; exact for
ints and bools) unless a case states its own tolerance.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from torch_port_utils import assert_parity, to_jax_args, to_port_args

torch.set_num_threads(1)

R = np.random.RandomState(0)
A = R.randn(3, 4).astype(np.float32)
B = R.randn(3, 4).astype(np.float32)
POS = (np.abs(A) + 0.5).astype(np.float32)
UNIT = R.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
I = R.randint(1, 10, (3, 4)).astype(np.int32)
J = R.randint(1, 4, (3, 4)).astype(np.int32)
V = R.randn(6).astype(np.float32)
W = R.randn(3).astype(np.float32)
M = R.randn(4, 5).astype(np.float32)
A3 = R.randn(2, 3, 4).astype(np.float32)
SQ = (R.randn(3, 3) + 3 * np.eye(3)).astype(np.float32)
I1 = np.array([3, 1, 2, 3, 3, 0, 1], np.int32)
I2 = np.array([1, 5, 3, 7], np.int32)
BOOL = A > 0
BOOL2 = B > 0
NANA = A.copy()
NANA[0, 1] = np.nan
NANA[2, 3] = np.nan
SORTED = np.sort(V)

# name -> (args, kwargs[, rtol]): numpy arrays become each package's arrays
CASES = {
    "add": ((A, B), {}), "subtract": ((A, B), {}),
    "multiply": ((A, 2.0), {}), "divide": ((A, POS), {}),
    "true_divide": ((I, J), {}), "floor_divide": ((A, POS), {}),
    "mod": ((A, POS), {}), "remainder": ((I, J), {}),
    "fmod": ((A, POS), {}), "power": ((POS, B), {}),
    "float_power": ((POS, B), {}), "negative": ((A,), {}),
    "positive": ((A,), {}), "absolute": ((A,), {}), "abs": ((I,), {}),
    "fabs": ((A,), {}), "sign": ((A,), {}), "rint": ((A * 3,), {}),
    "reciprocal": ((POS,), {}), "square": ((A,), {}), "sqrt": ((POS,), {}),
    "cbrt": ((A,), {}), "exp": ((A,), {}), "exp2": ((A,), {}),
    "expm1": ((A,), {}), "log": ((POS,), {}), "log2": ((POS,), {}),
    "log10": ((POS,), {}), "log1p": ((POS,), {}),
    "logaddexp": ((A, B), {}), "logaddexp2": ((A, B), {}),
    "sin": ((A,), {}), "cos": ((A,), {}), "tan": ((UNIT,), {}),
    "arcsin": ((UNIT,), {}), "arccos": ((UNIT,), {}),
    "arctan": ((A,), {}), "arctan2": ((A, B), {}), "sinh": ((A,), {}),
    "cosh": ((A,), {}), "tanh": ((A,), {}), "arcsinh": ((A,), {}),
    "arccosh": ((POS + 1,), {}), "arctanh": ((UNIT,), {}),
    "hypot": ((A, B), {}), "deg2rad": ((A,), {}), "rad2deg": ((A,), {}),
    "degrees": ((A,), {}), "radians": ((A,), {}), "ceil": ((A * 3,), {}),
    "floor": ((A * 3,), {}), "trunc": ((A * 3,), {}),
    "round": ((A * 3,), {}), "around": ((A * 30,), {"decimals": -1}),
    "clip": ((A, -0.5, 0.5), {}), "maximum": ((A, B), {}),
    "minimum": ((A, B), {}), "fmax": ((NANA, B), {}),
    "fmin": ((NANA, B), {}), "heaviside": ((A, B), {}),
    "nan_to_num": ((NANA,), {}), "real": ((A,), {}), "imag": ((A,), {}),
    "conj": ((A,), {}), "conjugate": ((A,), {}), "angle": ((A,), {}),
    "ldexp": ((A, J), {}), "frexp": ((A,), {}), "copysign": ((A, B), {}),
    "nextafter": ((A, B), {}), "spacing": ((A,), {}),
    "gcd": ((I, J), {}), "lcm": ((I, J), {}),
    "bitwise_and": ((I, J), {}), "bitwise_or": ((I, J), {}),
    "bitwise_xor": ((I, J), {}), "bitwise_not": ((I,), {}),
    "invert": ((BOOL,), {}), "left_shift": ((I, J), {}),
    "right_shift": ((I, J), {}), "sinc": ((A,), {}), "i0": ((A,), {}),
    "interp": ((V, SORTED, W.repeat(2)), {}),
    "equal": ((I, J), {}), "not_equal": ((I, J), {}),
    "less": ((A, B), {}), "less_equal": ((I, J), {}),
    "greater": ((A, B), {}), "greater_equal": ((I, J), {}),
    "logical_and": ((BOOL, BOOL2), {}), "logical_or": ((BOOL, BOOL2), {}),
    "logical_xor": ((BOOL, BOOL2), {}), "logical_not": ((BOOL,), {}),
    "isfinite": ((NANA,), {}), "isinf": ((A / 0.0,), {}),
    "isnan": ((NANA,), {}), "isneginf": ((A / 0.0,), {}),
    "isposinf": ((A / 0.0,), {}), "isclose": ((A, A + 1e-7), {}),
    "allclose": ((A, A + 1e-7), {}), "array_equal": ((I, I), {}),
    "array_equiv": ((I, I[0]), {}), "signbit": ((A,), {}),
    "sum": ((A,), {"axis": 1}), "prod": ((A,), {"axis": (0, 1)}),
    "mean": ((A,), {"axis": 0, "keepdims": True}),
    "std": ((A,), {"axis": 1, "ddof": 1}), "var": ((A,), {}),
    "min": ((A,), {"axis": 0}), "max": ((A,), {"axis": (0, 1)}),
    "amin": ((I,), {"axis": 1}), "amax": ((A,), {}),
    "ptp": ((A,), {"axis": 1}), "nansum": ((NANA,), {"axis": 0}),
    "nanprod": ((NANA,), {"axis": 1}), "nanmean": ((NANA,), {"axis": 1}),
    "nanstd": ((NANA,), {"axis": 1}), "nanvar": ((NANA,), {"axis": 0}),
    "nanmin": ((NANA,), {"axis": 1}), "nanmax": ((NANA,), {}),
    "argmin": ((A,), {"axis": 1}), "argmax": ((A,), {}),
    "nanargmin": ((NANA,), {"axis": 1}), "nanargmax": ((NANA,), {}),
    "median": ((A,), {"axis": 1}), "nanmedian": ((NANA,), {"axis": 1}),
    "percentile": ((A, 30.0), {"axis": 1}),
    "nanpercentile": ((NANA, 30.0), {"axis": 1}),
    "quantile": ((A, 0.3), {}), "nanquantile": ((NANA, 0.7), {"axis": 0}),
    "average": ((A,), {"axis": 0, "weights": W}),
    "cumsum": ((A,), {"axis": 1}), "cumprod": ((A,), {}),
    "nancumsum": ((NANA,), {"axis": 0}), "nancumprod": ((NANA,), {}),
    "all": ((BOOL,), {"axis": 0}), "any": ((BOOL,), {}),
    "count_nonzero": ((BOOL,), {"axis": 1}), "bincount": ((I1,), {}),
    "histogram": ((V,), {"bins": 4}),
    "histogram2d": ((V, V[::-1].copy()), {"bins": 3}),
    "corrcoef": ((A,), {}), "cov": ((A,), {}),
    "digitize": ((V, SORTED[1:4].copy()), {}),
    "dot": ((A, M), {}), "vdot": ((A, B), {}), "inner": ((A, B), {}),
    "outer": ((V, W), {}), "matmul": ((A, M), {}),
    "tensordot": ((A3, M), {"axes": 1}),
    "einsum": (("ij,jk->ik", A, M), {}), "kron": ((W, V), {}),
    "cross": ((A[:, :3].copy(), B[:, :3].copy()), {}),
    "trace": ((M,), {}), "diagonal": ((M,), {"offset": 1}),
    "reshape": ((A, (4, 3)), {}), "ravel": ((A,), {}),
    "transpose": ((A3,), {"axes": (2, 0, 1)}),
    "swapaxes": ((A3, 0, 2), {}), "moveaxis": ((A3, 0, -1), {}),
    "rollaxis": ((A3, 2), {}), "expand_dims": ((A, (0, 3)), {}),
    "squeeze": ((A[:, None],), {}), "broadcast_to": ((W[:, None], (3, 4)), {}),
    "broadcast_arrays": ((A, W[:, None]), {}),
    "atleast_1d": ((A,), {}), "atleast_2d": ((V,), {}),
    "atleast_3d": ((A,), {}), "concatenate": (([A, B],), {"axis": 1}),
    "stack": (([A, B],), {"axis": 1}), "vstack": (([A, B],), {}),
    "hstack": (([A, B],), {}), "dstack": (([A, B],), {}),
    "column_stack": (([V, V],), {}), "row_stack": (([A, B],), {}),
    "split": ((A, 2), {"axis": 1}), "array_split": ((A, 3), {"axis": 1}),
    "hsplit": ((A, [1, 3]), {}), "vsplit": ((M, 2), {}),
    "dsplit": ((A3, 2), {}), "tile": ((A, (2, 1)), {}),
    "repeat": ((A, 2), {"axis": 0}), "flip": ((A,), {"axis": 1}),
    "fliplr": ((A,), {}), "flipud": ((A,), {}),
    "roll": ((A, 1), {"axis": 1}), "rot90": ((A,), {}),
    "resize": ((A, (5, 3)), {}), "append": ((A, B), {"axis": 0}),
    "insert": ((V, 1, 5.0), {}), "delete": ((A, 1), {"axis": 1}),
    "pad": ((A, ((1, 1), (2, 0))), {}), "flatnonzero": ((BOOL,), {}),
    "take": ((A, np.array([0, 2, 3], np.int32)), {"axis": 1}),
    "take_along_axis": ((A, np.argsort(A, axis=1).astype(np.int32)),
                        {"axis": 1}),
    "choose": ((np.array([0, 1, 1, 0], np.int32), [A, B]), {}),
    "compress": ((np.array([True, False, True]), A), {"axis": 0}),
    "extract": ((BOOL, A), {}), "searchsorted": ((SORTED, W), {}),
    "argsort": ((A,), {"axis": 1}), "sort": ((A,), {"axis": 0}),
    "partition": ((V, 2), {}), "argpartition": ((V, 2), {}),
    "nonzero": ((BOOL,), {}), "argwhere": ((BOOL,), {}),
    "where": ((BOOL, A, B), {}),
    "unravel_index": ((np.array([1, 5, 11], np.int32), (3, 4)), {}),
    "ravel_multi_index": (((np.array([0, 2], np.int32),
                            np.array([1, 3], np.int32)), (3, 4)), {}),
    "diag": ((M,), {"k": 1}), "diagflat": ((W,), {"k": -1}),
    "tril": ((M,), {"k": 1}), "triu": ((M,), {}),
    "tril_indices": ((4,), {}), "triu_indices": ((4, 1), {}),
    "indices": (((2, 3),), {}), "ix_": ((I1[:2].copy(), I2[:3].copy()), {}),
    "select": (([BOOL, BOOL2], [A, B]), {}),
    "piecewise": ((V, [V < 0, V >= 0], [-1.0, 1.0]), {}),
    "unique": ((I1,), {"return_counts": True, "return_index": True}),
    "union1d": ((I1, I2), {}), "intersect1d": ((I1, I2), {}),
    "setdiff1d": ((I1, I2), {}), "setxor1d": ((I1, I2), {}),
    "in1d": ((I1, I2), {}), "isin": ((I, I2), {}),
    "eye": ((3,), {"k": 1}), "identity": ((3,), {}),
    "linspace": ((0.0, 1.0, 7), {}), "logspace": ((0.0, 2.0, 4), {}),
    "geomspace": ((1.0, 1000.0, 4), {}), "meshgrid": ((W, V), {}),
    "tri": ((3,), {"k": 1}), "vander": ((W,), {}),
    "fromfunction": ((lambda i, j: i + 2 * j, (2, 3)), {}),
    "diff": ((A,), {"axis": 1}), "ediff1d": ((V,), {}),
    "gradient": ((V,), {}), "trapezoid": ((A,), {}),
    "convolve": ((V, W), {}), "correlate": ((V, W), {"mode": "same"}),
    "hanning": ((5,), {}), "hamming": ((5,), {}), "blackman": ((5,), {}),
    "bartlett": ((5,), {}), "kaiser": ((5, 2.0), {}),
    "zeros_like": ((A,), {}), "ones_like": ((I,), {}),
    "full_like": ((A, 2.0), {}), "empty_like": ((A,), {}),
    "copy": ((A,), {}), "asarray": ((A,), {}),
    "ascontiguousarray": ((A,), {}), "shape": ((A,), {}),
    "size": ((A,), {}), "ndim": ((A3,), {}),
    "result_type": ((A, I), {}), "promote_types": (("int32", "float16"), {}),
    "can_cast": (("int32", "float32"), {}), "iscomplexobj": ((A,), {}),
    "isrealobj": ((A,), {}), "isscalar": ((3.0,), {}),
    "polyval": ((W, V), {}), "polyadd": ((W, V), {}),
    "polysub": ((W, V), {}), "polymul": ((W, V), {}),
    "polyder": ((V,), {}), "polyint": ((W,), {}),
    "polyfit": ((V, V * V - 2 * V, 2), {}, 1e-3),
    "apply_along_axis": ((lambda v: v * 2, 0, A), {}),
    "apply_over_axes": ((lambda x, axis: x.sum(axis=axis, keepdims=True),
                         A, [0]), {}),
    "put_along_axis": ((A.copy(), np.array([[0], [2], [1]], np.int32), 9.0,
                        1), {}),
    "fix": ((A * 3,), {}),
}

# a second case with int or bool inputs, where the result dtype rules
# differ between numpy, torch and the JAX package
INT_CASES = {
    "sum": ((I,), {}), "mean": ((I,), {"axis": 0}), "prod": ((J,), {}),
    "cumsum": ((I,), {"axis": 1}), "argmax": ((I,), {"axis": 0}),
    "add": ((BOOL, 1), {}), "multiply": ((I, 2.5), {}),
    "true_divide": ((I, 2), {}), "sqrt": ((I,), {}),
    "var": ((I,), {}), "max": ((I,), {}), "abs": ((I,), {}),
    "count_nonzero": ((I,), {}), "nansum": ((I,), {"axis": 1}),
    "power": ((I, J), {}), "floor_divide": ((I, J), {}),
    "ceil": ((I,), {}), "sum-bool": ((BOOL,), {"axis": 0}),
    "linspace": ((0, 10, 5), {"dtype": "int32"}),
    "eye": ((2,), {"dtype": "int32"}), "ones_like": ((BOOL,), {}),
}

PORT_ONLY = {"fallback_names", "fallback_calls"}


def _call(ns, name, args, kwargs):
    return getattr(ns, name.split("-")[0])(*args, **kwargs)


def _run(name, case):
    args, kwargs = case[0], case[1]
    rtol = case[2] if len(case) > 2 else None
    want = _call(jmx.np, name, to_jax_args(args), kwargs)
    with tmx.cpu():     # names with no array input make one on the CPU
        got = _call(tmx.np, name, to_port_args(args), kwargs)
    assert_parity(got, want, rtol=rtol, atol=None if rtol is None else rtol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_np_name_matches_jax(name):
    _run(name, CASES[name])


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_np_name_with_int_inputs_matches_jax(name):
    _run(name, INT_CASES[name])


def test_table_covers_every_exported_jax_name():
    jax_names = set(jmx.np.__all__)
    port_names = set(tmx.np.__all__)
    assert jax_names <= port_names, sorted(jax_names - port_names)
    # every function name of the JAX frontend has a parity case here
    consts = {"ndarray", "array", "zeros", "ones", "full", "empty",
              "arange", "random", "linalg", "newaxis", "pi", "e", "inf",
              "nan", "float32", "float64", "float16", "bfloat16", "int8",
              "int16", "int32", "int64", "uint8", "bool_", "save", "load",
              "waitall"}
    assert jax_names - consts <= set(CASES), sorted(
        jax_names - consts - set(CASES))


def test_fallbacks_are_only_names_torch_lacks():
    names = tmx.np.fallback_names()
    assert names == sorted(["insert", "piecewise",
                            "fromfunction", "apply_along_axis",
                            "apply_over_axes"])
    for n in names:
        assert not hasattr(torch, n), n
    # the table's names run through the dispatch, never the host
    tmx.np.fallback_calls(reset=True)
    x = tmx.np.array(A, device=tmx.cpu())
    (x + 1.0).sum()
    tmx.np.matmul(x, x.T)
    assert tmx.np.fallback_calls() == {}
    tmx.np.insert(x, 1, 0.0)
    assert tmx.np.fallback_calls() == {"insert": 1}


def test_put_along_axis_writes_the_ndarray_in_place():
    idx = np.array([[0], [2], [1]], np.int32)
    j = jmx.np.array(A)
    t = tmx.np.array(A, device=tmx.cpu())
    jmx.np.put_along_axis(j, jmx.np.array(idx), 7.0, 1)
    tmx.np.put_along_axis(t, tmx.np.array(idx, device=tmx.cpu()), 7.0, 1)
    assert_parity(t, j)


def test_scalar_ops_keep_a_16_bit_array_16_bit():
    for dt in ("bfloat16", "float16"):
        j = jmx.np.array(A, dtype=dt)
        t = tmx.np.array(A, dtype=dt, device=tmx.cpu())
        for f in (lambda x: x * 2.0, lambda x: 1.5 + x, lambda x: x / 3,
                  lambda x: x ** 2, lambda x: -x, lambda x: x - 1):
            assert_parity(f(t), f(j))


# ---------------------------------------------------------------------------
# int8, uint8, bool and float16 inputs (ROADMAP C8): the JAX package's result
# dtype and values, name by name; float16 results within the float16
# parity tolerance (the port takes a float16 median or quantile in float32
# and rounds once, the JAX package computes in float16)
# ---------------------------------------------------------------------------
U8 = np.array([[1, 2, 250], [7, 0, 3]], np.uint8)
I8 = np.array([[1, -2, 100], [-7, 0, 3]], np.int8)
F16 = np.array([[1.5, 2.0, 3.0], [2.5, -1.0, 0.5]], np.float16)
BOOLS = np.array([[True, False, True], [False, False, True]])
I32 = np.array([4, -3, 7, 0], np.int32)

SMALL_CASES = {
    "all-uint8": ((U8,), {}), "any-uint8": ((U8,), {"axis": 1}),
    "all-int8": ((I8,), {"axis": 0}), "any-float16": ((F16,), {}),
    "cumsum-int8": ((I8,), {}), "cumsum-uint8": ((U8,), {"axis": 1}),
    "cumprod-uint8": ((U8,), {}), "cumprod-int8": ((I8,), {"axis": 0}),
    "nancumsum-uint8": ((U8,), {}), "nancumprod-int8": ((I8,), {}),
    "cumsum-bool": ((BOOLS,), {}), "cumsum-float16": ((F16,), {}),
    "median-float16": ((F16,), {}), "median-float16-axis": ((F16,),
                                                             {"axis": 1}),
    "percentile-float16": ((F16, 30.0), {}),
    "quantile-float16": ((F16, 0.7), {"axis": 0}),
    "nanmedian-float16": ((F16,), {}),
    "nanpercentile-float16": ((F16, 60.0), {}),
    "nanquantile-float16": ((F16, 0.25), {}),
    "argmax-bool": ((BOOLS,), {}), "argmin-bool": ((BOOLS,), {"axis": 1}),
    "floor_divide-int32-by-0": ((I32, 0), {}),
    "floor_divide-int8-by-0": ((I8, 0), {}),
    "floor_divide-uint8-by-0": ((U8, 0), {}),
    "floor_divide-int32-by-zeros": ((I32, np.array([2, 0, -2, 0],
                                                   np.int32)), {}),
    "mod-int32-by-0": ((I32, 0), {}), "remainder-int8-by-0": ((I8, 0), {}),
    "fmod-int32-by-0": ((I32, 0), {}),
    "power-int32-integral-float": ((I32, 2.0), {}),
    "power-int8-int": ((I8, 2), {}),
    "sum-int8": ((I8,), {"axis": 1}), "mean-uint8": ((U8,), {}),
    "max-bool": ((BOOLS,), {}), "diff-bool": ((BOOLS,), {}),
    "sort-bool": ((BOOLS,), {"axis": 1}), "abs-int8": ((I8,), {}),
    "negative-uint8": ((U8,), {}), "sum-float16": ((F16,), {}),
    "mean-float16": ((F16,), {}), "var-uint8": ((U8,), {}),
    "ediff1d-int8": ((I8,), {}),
}


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_np_name_with_small_dtype_inputs_matches_jax(name):
    _run(name, SMALL_CASES[name])


OPERATORS = {
    "floordiv-by-0": (lambda a: a // 0, I32),
    "mod-by-0": (lambda a: a % 0, I8),
    "floordiv-uint8-by-0": (lambda a: a // 0, U8),
    "pow-integral-float": (lambda a: a ** 3.0, I32),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_with_small_dtype_inputs_matches_jax(name):
    fn, a = OPERATORS[name]
    assert_parity(fn(tmx.np.array(a, device=tmx.cpu())),
                  fn(jmx.np.array(a)))


REFUSALS = {
    "squeeze-non-unit-axis": (lambda m, a: m.np.squeeze(a, axis=0), F16,
                              ValueError),
    "ndarray-squeeze-non-unit-axis": (lambda m, a: a.squeeze(axis=0), F16,
                                      ValueError),
    "power-int-negative": (lambda m, a: m.np.power(a, -1), I32, TypeError),
    "power-bool-negative": (lambda m, a: m.np.power(a, -1), BOOLS,
                            TypeError),
    "ediff1d-bool": (lambda m, a: m.np.ediff1d(a), BOOLS, TypeError),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_np_refusals_match_jax(name):
    fn, a, err = REFUSALS[name]
    with pytest.raises(err):
        fn(jmx, jmx.np.array(a))
    with pytest.raises(err):
        fn(tmx, tmx.np.array(a, device=tmx.cpu()))


@pytest.mark.parametrize("name", ["sum", "prod", "nansum", "nanprod",
                                  "trace"])
def test_unsigned_reductions_are_int32_where_the_jax_package_says_uint32(
        name):
    """A deliberate difference (ROADMAP §C): the JAX package sums and
    multiplies uint8 into uint32; the port has no uint32 array type
    (`base._TO_TORCH` maps it to int32: torch.uint32 has no add, compare,
    max, floor_divide, neg or pow on the CPU), so the result is int32 with
    the same values below 2**31. This test fails if either side changes."""
    a = U8[:, :2] if name == "trace" else U8
    want = getattr(jmx.np, name)(jmx.np.array(a))
    got = getattr(tmx.np, name)(tmx.np.array(a, device=tmx.cpu()))
    assert str(want.dtype) == "uint32" and str(got.dtype) == "int32"
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
