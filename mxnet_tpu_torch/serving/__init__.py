"""Serving (counterpart of ``mxnet_tpu/serving``): the bucketed
:class:`CompiledPredictor`, the :class:`DynamicBatcher` and the
closed-loop load generator."""
from . import loadgen
from .batcher import DynamicBatcher, Overloaded, ServingFuture, \
    ServingShutdown
from .predictor import DEFAULT_BUCKETS, CompiledPredictor

__all__ = ["CompiledPredictor", "DEFAULT_BUCKETS", "DynamicBatcher",
           "ServingFuture", "Overloaded", "ServingShutdown", "loadgen"]
