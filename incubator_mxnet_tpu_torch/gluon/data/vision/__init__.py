"""gluon.data.vision of the PyTorch port
(≙ python/mxnet/gluon/data/vision/)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms
