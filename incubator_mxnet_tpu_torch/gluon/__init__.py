"""Gluon of the PyTorch port: blocks, layers, losses, the ResNet v1 model
zoo and the fused training step.

Counterpart of `incubator_mxnet_tpu/gluon/`. Ported so far: `HybridBlock`
(`block`), the layers ResNet and the transformer blocks need (`nn`,
`nn.transformer`), `loss.SoftmaxCrossEntropyLoss`,
`model_zoo.vision` (ResNet v1), `contrib.FusedTrainStep`, and
`params_from_jax`, which carries the JAX package's values into a port net.
`Trainer`, `autograd.record`, the data pipeline and the rest of the layers
are not ported yet.
"""
from . import nn, loss, model_zoo, contrib
from .block import HybridBlock, params_from_jax

__all__ = ["HybridBlock", "params_from_jax", "nn", "loss", "model_zoo",
           "contrib"]
