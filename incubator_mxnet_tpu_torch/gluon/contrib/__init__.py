"""gluon.contrib of the PyTorch port: the Estimator fit loop and the fused
training and inference steps."""
from . import estimator
from .fused import FusedInferStep, FusedTrainStep

__all__ = ["estimator", "FusedTrainStep", "FusedInferStep"]
