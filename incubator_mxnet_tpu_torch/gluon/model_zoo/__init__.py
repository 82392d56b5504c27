"""gluon.model_zoo of the PyTorch port: the vision catalog, SSD, and the
local pretrained-weight store."""
from . import detection, model_store, vision
from .vision import get_model

__all__ = ["detection", "model_store", "vision", "get_model"]
