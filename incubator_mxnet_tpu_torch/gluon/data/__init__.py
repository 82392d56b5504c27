"""gluon.data of the PyTorch port (≙ python/mxnet/gluon/data/):
Dataset/Sampler/DataLoader."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset, _LazyTransformDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      FilterSampler)
from .dataloader import DataLoader, default_batchify_fn
from . import batchify
from . import vision
