"""gluon.contrib of the PyTorch port: the fused training and inference
steps."""
from .fused import FusedInferStep, FusedTrainStep

__all__ = ["FusedTrainStep", "FusedInferStep"]
