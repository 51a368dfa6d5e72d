"""ResNet V1 and V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``): He et al. 1512.03385
(V1) and 1603.05027 (V2), with the "ResNet 1.5" stride of the
reference: a bottleneck's stride sits on its 3x3 convolution.

Children are named as in the JAX package (``features.0.weight``,
``features.4.0.body.1.running_mean``, ``output.weight``), so a dict of
its ``collect_params()`` loads as it is. Shapes are not inferred: every
layer is given its ``in_channels`` (3 for the images). Weights are the
layers' random initial ones (``device=`` / ``generator=`` reach every
layer); ``pretrained=True`` raises, there is no model store.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn as tnn

from ....base import MXNetError
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "resnet_spec",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, **kw):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, **kw)


def _conv1x1(channels, stride, in_channels, **kw):
    return nn.Conv2D(channels, kernel_size=1, strides=stride,
                     use_bias=False, in_channels=in_channels, **kw)


def _bn(channels, device, **kw):
    return nn.BatchNorm(in_channels=channels, device=device, **kw)


class BasicBlockV1(tnn.Module):
    """Two 3x3 conv-BN(-ReLU) layers and the identity (or a strided 1x1
    conv-BN) added, then ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.body = nn.HybridSequential(
            _conv3x3(channels, stride, in_channels, **kw),
            _bn(channels, device), nn.Activation("relu"),
            _conv3x3(channels, 1, channels, **kw), _bn(channels, device))
        self.downsample = nn.HybridSequential(
            _conv1x1(channels, stride, in_channels, **kw),
            _bn(channels, device)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BottleneckV1(tnn.Module):
    """1x1 - 3x3 (strided) - 1x1 conv-BN layers to ``channels``, the
    middle ``channels // 4`` wide, and the identity (or a strided 1x1
    conv-BN) added, then ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = channels // 4
        self.body = nn.HybridSequential(
            _conv1x1(mid, 1, in_channels, **kw), _bn(mid, device),
            nn.Activation("relu"),
            _conv3x3(mid, stride, mid, **kw), _bn(mid, device),
            nn.Activation("relu"),
            _conv1x1(channels, 1, mid, **kw), _bn(channels, device))
        self.downsample = nn.HybridSequential(
            _conv1x1(channels, stride, in_channels, **kw),
            _bn(channels, device)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BasicBlockV2(tnn.Module):
    """Pre-activation block: BN-ReLU-conv twice, the identity (or a
    strided 1x1 conv of the first activation) added."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.bn1 = _bn(in_channels, device)
        self.conv1 = _conv3x3(channels, stride, in_channels, **kw)
        self.bn2 = _bn(channels, device)
        self.conv2 = _conv3x3(channels, 1, channels, **kw)
        self.downsample = _conv1x1(channels, stride, in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(torch.relu(self.bn2(x)))
        return x + residual


class BottleneckV2(tnn.Module):
    """Pre-activation bottleneck: BN-ReLU-conv 1x1, 3x3 (strided), 1x1,
    the identity (or a strided 1x1 conv of the first activation)
    added."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = channels // 4
        self.bn1 = _bn(in_channels, device)
        self.conv1 = _conv1x1(mid, 1, in_channels, **kw)
        self.bn2 = _bn(mid, device)
        self.conv2 = _conv3x3(mid, stride, mid, **kw)
        self.bn3 = _bn(mid, device)
        self.conv3 = _conv1x1(channels, 1, mid, **kw)
        self.downsample = _conv1x1(channels, stride, in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(torch.relu(self.bn2(x)))
        x = self.conv3(torch.relu(self.bn3(x)))
        return x + residual


def _make_layer(block, layers, channels, stride, in_channels, kw):
    layer = nn.HybridSequential(block(channels, stride,
                                      channels != in_channels,
                                      in_channels=in_channels, **kw))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels, **kw))
    return layer


class ResNetV1(tnn.Module):
    """``features`` (the stem: a 7x7 stride-2 conv, BN, ReLU and a 3x3
    stride-2 max pool, or one 3x3 conv with ``thumbnail``; the stages;
    a global average pool) and the ``output`` Dense layer."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1: len(layers) must be "
                             "len(channels) - 1")
        kw = dict(device=device, generator=generator)
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, in_channels, **kw))
        else:
            self.features.add(
                nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                          in_channels=in_channels, **kw),
                _bn(channels[0], device), nn.Activation("relu"),
                nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, channels[i],
                                          kw))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1], **kw)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(tnn.Module):
    """``features`` (a BN of the input with no scale or shift, the stem
    as V1's, the pre-activation stages, BN, ReLU, a global average pool,
    Flatten) and the ``output`` Dense layer."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2: len(layers) must be "
                             "len(channels) - 1")
        kw = dict(device=device, generator=generator)
        self.features = nn.HybridSequential(
            _bn(in_channels, device, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, in_channels, **kw))
        else:
            self.features.add(
                nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                          in_channels=in_channels, **kw),
                _bn(channels[0], device), nn.Activation("relu"),
                nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, channels[i],
                                          kw))
        self.features.add(_bn(channels[-1], device), nn.Activation("relu"),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes, in_units=channels[-1], **kw)

    def forward(self, x):
        return self.output(self.features(x))


#: depth -> (block kind, blocks a stage, channels: the stem's, then each
#: stage's), the reference's ``resnet_spec``
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``num_layers`` (18, 34, 50, 101, 152) of ``version`` (1 or
    2). ``kwargs`` go to the net (``classes``, ``thumbnail``,
    ``device``, ``generator``)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; options "
                         f"{sorted(resnet_spec)}")
    if version not in (1, 2):
        raise MXNetError("resnet version must be 1 or 2")
    if pretrained:
        raise MXNetError(f"resnet{num_layers}_v{version}(pretrained=True): "
                         "the port has no model store to load pretrained "
                         "weights from; load a parameter file with "
                         "gluon.load_parameters instead")
    block_type, layers, channels = resnet_spec[num_layers]
    block = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block, layers, channels,
                                            **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
