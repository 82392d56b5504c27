"""AMP op lists of the PyTorch port: the port's own copy of
`incubator_mxnet_tpu/amp/lists.py`, name for name, so that both packages
cast the same ops to the same dtypes.

BF16_FUNCS: matrix-product-bound ops that are safe and fast in bf16.
FP32_FUNCS: numerically sensitive ops pinned to fp32.
Everything else: the op's own class (`safe`/`unsafe`), else left alone.
"""

BF16_FUNCS = {
    # matmul/conv class (the FLOPs)
    "dot", "matmul", "batch_dot", "convolution", "deconvolution",
    "fully_connected", "einsum", "tensordot", "inner", "outer", "kron",
    "conv", "dense", "scaled_dot_product_attention",
    # cheap elementwise that feed the matrix units
    "relu", "leaky_relu", "activation", "add", "subtract", "multiply",
    "maximum", "minimum", "concat", "stack", "reshape", "transpose",
    "pooling",
}

FP32_FUNCS = {
    # reductions & normalizations (accumulate in fp32)
    "softmax", "log_softmax", "masked_softmax", "softmin",
    "batch_norm", "layer_norm", "group_norm", "instance_norm", "rms_norm",
    "l2_normalization", "norm", "sum", "mean", "prod", "var", "std",
    "cumsum", "logsumexp",
    # math with precision cliffs
    "exp", "expm1", "log", "log1p", "log2", "log10", "power", "sqrt",
    "rsqrt", "cbrt", "square", "reciprocal", "erf", "erfinv", "gamma",
    "gammaln", "digamma", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "arcsinh", "arccosh", "arctanh",
    # losses
    "ctc_loss", "smooth_l1", "true_divide", "divide", "mod",
}
