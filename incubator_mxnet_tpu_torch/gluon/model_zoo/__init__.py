"""gluon.model_zoo of the PyTorch port."""
from . import vision

__all__ = ["vision"]
