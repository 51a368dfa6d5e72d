"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from . import datasets, transforms
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset)

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset", "datasets",
           "transforms"]
