"""Data loading for training (counterpart of ``mxnet_tpu/gluon/data``):
datasets, samplers, batchify functions, the threaded :class:`DataLoader`
and the device prefetcher it stages batches through (which
``TrainLoop.prefetch`` wraps too); ``vision`` holds the image datasets
and transforms."""
from . import batchify, prefetcher, vision
from .dataloader import DataLoader, default_batchify_fn
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .prefetcher import DevicePrefetcher, default_prefetch_depth
from .sampler import (BatchSampler, FilterSampler, IntervalSampler,
                      RandomSampler, Sampler, SequentialSampler)

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler", "DataLoader",
           "default_batchify_fn", "DevicePrefetcher",
           "default_prefetch_depth", "batchify", "prefetcher", "vision"]
