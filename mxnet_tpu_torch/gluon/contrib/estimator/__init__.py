"""The Estimator (counterpart of ``mxnet_tpu/gluon/contrib/estimator``)."""
from .estimator import Estimator
from .event_handler import (BatchBegin, BatchEnd, CheckpointHandler,
                            EarlyStoppingHandler, EpochBegin, EpochEnd,
                            EventHandler, LoggingHandler, MetricHandler,
                            StoppingHandler, TrainBegin, TrainEnd,
                            ValidationHandler)

__all__ = ["Estimator", "EventHandler", "TrainBegin", "TrainEnd",
           "EpochBegin", "EpochEnd", "BatchBegin", "BatchEnd",
           "StoppingHandler", "MetricHandler", "ValidationHandler",
           "LoggingHandler", "CheckpointHandler", "EarlyStoppingHandler"]
