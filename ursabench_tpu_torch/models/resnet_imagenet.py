"""ImageNet-style ResNets, NCHW: INResNet18..152 (3x3 stride-1 stem for 32x32
inputs) and TVResNet18/50 (the torchvision architecture: 7x7/2 stem and
3x3/2 max-pool).

Counterpart of ``ursabench_tpu/models/resnet_imagenet.py``: BasicBlock and
Bottleneck (stride on the 3x3, BN'd 1x1 shortcut when the shape changes),
global average pooling in float32, a float32 linear head. INResNet draws its
convs and head with ``kaiming_normal``, TVResNet its convs fan-out normal
and its head as torch's ``nn.Linear`` does. ``dtype`` is flax's compute
dtype (``models/common.py``). The JAX package computes TVResNet's stem on a
space-to-depth input by default, an exact rewrite for the TPU's matrix unit
with the same parameters; here the stem is the plain 7x7/2 convolution.

Children are registered in the order the flax modules create them, per
layer type (conv1, bn1, conv2, bn2, [conv3, bn3,] then the shortcut's conv
and BN), so ``transfer.params_from_jax`` pairs them with ``Conv_k`` /
``BatchNorm_k``; the blocks keep flax's class names (``Bottleneck_k``).
Max-pool and ReLU are functions, not child modules. The ``_dropout`` twins
(INResNet50_dropout, ResNet_dropout, TVResNet50_dropout) apply dropout 0.2
to the pooled features, active in eval mode too (``models/common.Dropout``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import CIFAR_TEST, CIFAR_TRAIN, IMAGENET_TEST, IMAGENET_TRAIN
from ..nn.init import fan_out_normal_, kaiming_normal_, torch_linear_, torch_linear_bias_
from .common import BatchNorm2d, Conv2d, Dropout, ModelCfg, register


def _shortcut(inplanes: int, planes: int, stride: int, dtype):
    if stride == 1 and inplanes == planes:
        return None
    return nn.Sequential(Conv2d(inplanes, planes, 1, stride, 0, dtype),
                         BatchNorm2d(planes, dtype=dtype))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.downsample = _shortcut(inplanes, planes, stride, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(out + shortcut)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, 1, 0, dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, 1, 0, dtype)
        self.bn3 = BatchNorm2d(planes * 4, dtype=dtype)
        self.downsample = _shortcut(inplanes, planes * 4, stride, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(out + shortcut)


class INResNet(nn.Module):
    """``layers`` blocks in each of the four stages (64, 128, 256, 512
    planes, strides 1, 2, 2, 2) after a 3x3 stride-1 stem."""

    stem_kernel, stem_stride, max_pool = 3, 1, False

    def __init__(self, layers: Sequence[int], bottleneck: bool = False,
                 num_classes: int = 10, dtype=None, in_channels: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        block = Bottleneck if bottleneck else BasicBlock
        k = self.stem_kernel
        self.conv1 = Conv2d(in_channels, 64, k, self.stem_stride, k // 2, dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
        inplanes = 64
        for i, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                    (1, 2, 2, 2))):
            blocks = []
            for j in range(n):
                blocks.append(block(inplanes, planes, stride if j == 0 else 1, dtype))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.dropout = Dropout(dropout, always=True) if dropout > 0 else None
        self.fc = nn.Linear(inplanes, num_classes)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's initialisation, drawn from ``gen``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(m.weight, gen)
            elif isinstance(m, nn.Linear):
                kaiming_normal_(m.weight, gen)
                torch_linear_bias_(m.bias, m.in_features, gen)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.max_pool:
            out = F.max_pool2d(out, 3, 2, 1)
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = out.to(torch.float32).mean(dim=(2, 3))
        if self.dropout is not None:
            out = self.dropout(out)
        return self.fc(out)


class TVResNet(INResNet):
    """torchvision's ResNet: 7x7/2 pad-3 stem and a 3x3/2 pad-1 max-pool,
    fan-out normal convs and torch's default linear head."""

    stem_kernel, stem_stride, max_pool = 7, 2, True

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out_normal_(m.weight, gen)
            elif isinstance(m, nn.Linear):
                torch_linear_(m.weight, m.bias, gen)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()


def _cfg(name: str, cls, layers, bottleneck: bool, train, test,
         dropout: float = 0.0) -> ModelCfg:
    return register(
        ModelCfg(
            name=name,
            make=lambda num_classes, **kw: cls(num_classes=num_classes, **kw),
            transform_train=train,
            transform_test=test,
            kwargs={"layers": layers, "bottleneck": bottleneck,
                    **({"dropout": dropout} if dropout else {})},
        )
    )


INResNet18 = _cfg("INResNet18", INResNet, (2, 2, 2, 2), False, CIFAR_TRAIN, CIFAR_TEST)
INResNet34 = _cfg("INResNet34", INResNet, (3, 4, 6, 3), False, CIFAR_TRAIN, CIFAR_TEST)
INResNet50 = _cfg("INResNet50", INResNet, (3, 4, 6, 3), True, CIFAR_TRAIN, CIFAR_TEST)
# alias used by the tuned-hyperparameter library group names (ResNet50*)
ResNet50 = _cfg("ResNet50", INResNet, (3, 4, 6, 3), True, CIFAR_TRAIN, CIFAR_TEST)
INResNet101 = _cfg("INResNet101", INResNet, (3, 4, 23, 3), True, CIFAR_TRAIN, CIFAR_TEST)
INResNet152 = _cfg("INResNet152", INResNet, (3, 8, 36, 3), True, CIFAR_TRAIN, CIFAR_TEST)
TVResNet18 = _cfg("TVResNet18", TVResNet, (2, 2, 2, 2), False, IMAGENET_TRAIN,
                  IMAGENET_TEST)
TVResNet50 = _cfg("TVResNet50", TVResNet, (3, 4, 6, 3), True, IMAGENET_TRAIN,
                  IMAGENET_TEST)
INResNet50_dropout = _cfg("INResNet50_dropout", INResNet, (3, 4, 6, 3), True, CIFAR_TRAIN,
                          CIFAR_TEST, dropout=0.2)
ResNet_dropout = _cfg("ResNet_dropout", INResNet, (3, 4, 6, 3), True, CIFAR_TRAIN, CIFAR_TEST,
                      dropout=0.2)
TVResNet50_dropout = _cfg("TVResNet50_dropout", TVResNet, (3, 4, 6, 3), True, IMAGENET_TRAIN,
                          IMAGENET_TEST, dropout=0.2)
