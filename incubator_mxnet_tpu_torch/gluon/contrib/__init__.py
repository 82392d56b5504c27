"""gluon.contrib of the PyTorch port: the fused training step."""
from .fused import FusedTrainStep

__all__ = ["FusedTrainStep"]
