"""Gluon of the PyTorch port: blocks, Parameters, the Trainer, layers,
losses, the ResNet v1 model zoo and the fused training step.

Counterpart of `incubator_mxnet_tpu/gluon/`. Ported so far: `HybridBlock`
(`block`), `Parameter` with deferred initialization (`parameter`),
`Trainer` (`trainer`), the layers ResNet and the transformer blocks need
(`nn`, `nn.transformer`), `loss.SoftmaxCrossEntropyLoss`,
`model_zoo.vision` (ResNet v1), `contrib.FusedTrainStep`, and
`params_from_jax`, which carries the JAX package's values into a port net.
The data pipeline and the rest of the layers are not ported yet.
"""
from . import nn, loss, model_zoo, contrib
from .block import HybridBlock, params_from_jax
from .parameter import Constant, DeferredInitializationError, Parameter
from .trainer import Trainer

__all__ = ["HybridBlock", "Parameter", "Constant",
           "DeferredInitializationError", "Trainer", "params_from_jax", "nn",
           "loss", "model_zoo", "contrib"]
