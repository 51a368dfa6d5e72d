"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``; ports the ResNets).

``get_model(name, **kwargs)`` builds a model by its reference name.
"""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = list(_resnet_all) + ["get_model"]

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """Build a model by name (``resnet50_v1``, ...); ``kwargs`` go to its
    constructor."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"model {name} is not in the zoo; available: {sorted(_models)}")
    return _models[name](**kwargs)
