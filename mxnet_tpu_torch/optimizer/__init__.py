"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (SGD, Adam, AdamW, Optimizer, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Updater", "get_updater",
           "create", "register"]
