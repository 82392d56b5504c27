"""mx.models of the PyTorch port — flagship end-to-end model definitions.

Counterpart of `incubator_mxnet_tpu/models/`: the transformer LM, a
functional model over a params tree with an AdamW step, on one device.
(Its mesh-sharded and pipelined steps wait for the port's mesh, ROADMAP
A10.)
"""
from . import transformer
