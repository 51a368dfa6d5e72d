"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (DCASGD, FTML, LAMB, LANS, LARS, NAG, SGD, SGLD,
                        AdaBelief, AdaDelta, AdaGrad, Adam, Adamax, AdamW,
                        Ftrl, GroupAdaGrad, Nadam, Optimizer, RMSProp,
                        Signum, Updater, create, get_updater, register)

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "SGLD", "DCASGD", "Adam",
           "AdamW", "AdaBelief", "Adamax", "Nadam", "AdaGrad",
           "GroupAdaGrad", "AdaDelta", "RMSProp", "Ftrl", "FTML", "LARS",
           "LAMB", "LANS", "Updater", "get_updater", "create", "register"]
