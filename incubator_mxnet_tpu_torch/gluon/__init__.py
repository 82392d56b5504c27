"""Gluon of the PyTorch port: blocks, Parameters, the Trainer, layers,
losses, metrics, utilities, the model zoo and the fused steps.

Counterpart of `incubator_mxnet_tpu/gluon/`. Ported so far: `Block` and
`HybridBlock` (`block`), `Parameter` with deferred initialization
(`parameter`), `Trainer` (`trainer`), the layers of `nn` (containers,
Dense, the 1-3-D convolutions and pools, the norms, the activations, the
transformer blocks), every loss of `loss`, every metric of `metric`,
`utils` (`split_and_load`, `clip_global_norm`), `model_zoo.vision` (ResNet
v1 and v2, MobileNet v1 and v2), `contrib.FusedTrainStep` and
`contrib.FusedInferStep`, `params_from_jax`, which carries the JAX
package's values into a port net, and `data` (datasets, samplers,
batchify, `DataLoader`, `vision` datasets and transforms).
"""
from . import nn, loss, metric, utils, model_zoo, contrib, data
from .block import Block, HybridBlock, params_from_jax
from .parameter import Constant, DeferredInitializationError, Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "Constant",
           "DeferredInitializationError", "Trainer", "params_from_jax", "nn",
           "loss", "metric", "utils", "model_zoo", "contrib", "data"]
