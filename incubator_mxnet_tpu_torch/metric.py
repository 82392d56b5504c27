"""mx.metric of the PyTorch port: the alias of `gluon.metric` (MXNet
exposes both `mx.gluon.metric` and the older `mx.metric`)."""
from .gluon.metric import *  # noqa: F401,F403
from .gluon.metric import create, EvalMetric, CompositeEvalMetric  # noqa: F401
