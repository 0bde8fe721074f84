"""CIFAR ResNets with option-A (parameter-free) shortcuts, NCHW:
ResNet20/32/44/56/110/1202.

Counterpart of ``ursabench_tpu/models/resnet_cifar.py``: a 3x3 stem conv of
16 channels, three stages of basic blocks (16, 32, 64 channels, strides 1,
2, 2), bias-free convs with kaiming-normal initialisation, BatchNorm with
flax's running statistics and momentum 0.9 (0.1 in torch's convention, the
default of ``models/common.BatchNorm2d``). Where a block changes the shape,
its shortcut subsamples ``x[:, :, ::2, ::2]`` and pads ``planes // 4`` zero
channels on each side. Global average pooling and the kaiming-normal head
run in float32; ``dtype`` is flax's compute dtype (``models/common.py``).

Children are registered in flax's creation order per layer type (the stem
``Conv_0``/``BatchNorm_0``, the blocks ``BasicBlockA_k``, the head
``Dense_0``), so ``transfer.params_from_jax`` pairs them by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import CIFAR_TEST, CIFAR_TRAIN
from ..nn.init import kaiming_normal_, torch_linear_bias_
from .common import BatchNorm2d, Conv2d, ModelCfg, register


class BasicBlockA(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.pad = planes // 4 if stride != 1 or in_planes != planes else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        shortcut = x
        if self.pad is not None:  # option A: subsample, zero-pad the channels
            shortcut = F.pad(x[:, :, ::2, ::2], (0, 0, 0, 0, self.pad, self.pad))
        return F.relu(out + shortcut)


class CifarResNet(nn.Module):
    def __init__(self, num_blocks=(3, 3, 3), num_classes: int = 10, dtype=None):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.conv1 = Conv2d(3, 16, 3, 1, 1, dtype)
        self.bn1 = BatchNorm2d(16, dtype=dtype)
        blocks, in_planes = [], 16
        for planes, n, stride in zip((16, 32, 64), num_blocks, (1, 2, 2)):
            for s in [stride] + [1] * (n - 1):
                blocks.append(BasicBlockA(in_planes, planes, s, dtype))
                in_planes = planes
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(64, num_classes)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's initialisation, drawn from ``gen``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(m.weight, gen)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()
        kaiming_normal_(self.fc.weight, gen)
        torch_linear_bias_(self.fc.bias, 64, gen)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        for blk in self.blocks:
            out = blk(out)
        return self.fc(out.to(torch.float32).mean(dim=(2, 3)))


def _cfg(name: str, blocks) -> ModelCfg:
    return register(
        ModelCfg(
            name=name,
            make=lambda num_classes, **kw: CifarResNet(
                num_blocks=kw.get("num_blocks", blocks), num_classes=num_classes,
                dtype=kw.get("dtype")),
            transform_train=CIFAR_TRAIN,
            transform_test=CIFAR_TEST,
            kwargs={"num_blocks": blocks},
        )
    )


ResNet20 = _cfg("ResNet20", (3, 3, 3))
ResNet32 = _cfg("ResNet32", (5, 5, 5))
ResNet44 = _cfg("ResNet44", (7, 7, 7))
ResNet56 = _cfg("ResNet56", (9, 9, 9))
ResNet110 = _cfg("ResNet110", (18, 18, 18))
ResNet1202 = _cfg("ResNet1202", (200, 200, 200))
