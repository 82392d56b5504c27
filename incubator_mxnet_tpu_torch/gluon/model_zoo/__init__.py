"""gluon.model_zoo of the PyTorch port."""
from . import detection, vision

__all__ = ["detection", "vision"]
