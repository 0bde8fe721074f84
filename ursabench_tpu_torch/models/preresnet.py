"""Pre-activation ResNet (PreResNet8/20/56/83/110/164), NCHW.

Counterpart of ``ursabench_tpu/models/preresnet.py``: basic blocks for
depth < 44 ((d-2) % 6 == 0), bottlenecks (x4 expansion) for depth >= 44
((d-2) % 9 == 0); fan-out normal convs without bias; a 1x1 conv without BN
as the downsample; float32 global average pooling. ``dtype`` is flax's
compute dtype (``models/common.py``): convs and BatchNorm run in it, the
pooling and the head in float32.

Each module registers its children in the order the flax module creates
them (per layer type), so ``transfer.params_from_jax`` can pair them with
flax's ``Conv_k`` / ``BatchNorm_k`` / ``Dense_k`` names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import CIFAR_TEST, CIFAR_TRAIN
from ..nn.init import fan_out_normal_, torch_linear_
from .common import BatchNorm2d, Conv2d, ModelCfg, register


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, dtype=None) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, kernel // 2, dtype)


class PreBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=None):
        super().__init__()
        self.bn1 = BatchNorm2d(inplanes, dtype=dtype)
        self.downsample = _conv(inplanes, planes, 1, stride, dtype) if downsample else None
        self.conv1 = _conv(inplanes, planes, 3, stride, dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        residual = self.downsample(x) if self.downsample is not None else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        return out + residual


class PreBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=None):
        super().__init__()
        self.bn1 = BatchNorm2d(inplanes, dtype=dtype)
        self.downsample = (_conv(inplanes, planes * 4, 1, stride, dtype)
                           if downsample else None)
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, stride, dtype)
        self.bn3 = BatchNorm2d(planes, dtype=dtype)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        residual = self.downsample(x) if self.downsample is not None else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + residual


class PreResNet(nn.Module):
    def __init__(self, depth: int = 110, num_classes: int = 10, in_channels: int = 3,
                 dtype=None):
        super().__init__()
        if depth >= 44:
            if (depth - 2) % 9:
                raise ValueError("depth should be 9n+2")
            n, block = (depth - 2) // 9, PreBottleneck
        else:
            if (depth - 2) % 6:
                raise ValueError("depth should be 6n+2")
            n, block = (depth - 2) // 6, PreBasicBlock
        self.conv1 = _conv(in_channels, 16, 3, dtype=dtype)
        blocks = []
        inplanes = 16
        for planes, stride in zip((16, 32, 64), (1, 2, 2)):
            for i in range(n):
                s = stride if i == 0 else 1
                down = i == 0 and (s != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, s, down, dtype))
                inplanes = planes * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.bn = BatchNorm2d(inplanes, dtype=dtype)
        self.fc = nn.Linear(inplanes, num_classes)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's initialisation, drawn from ``gen``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out_normal_(m.weight, gen)
            elif isinstance(m, nn.Linear):
                torch_linear_(m.weight, m.bias, gen)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        out = self.conv1(x)
        for blk in self.blocks:
            out = blk(out)
        out = F.relu(self.bn(out))
        out = out.to(torch.promote_types(out.dtype, torch.float32)).mean(dim=(2, 3))
        return self.fc(out)


def _cfg(name: str, depth: int) -> ModelCfg:
    return register(
        ModelCfg(
            name=name,
            make=lambda num_classes, **kw: PreResNet(
                depth=kw.get("depth", depth), num_classes=num_classes,
                dtype=kw.get("dtype")),
            transform_train=CIFAR_TRAIN,
            transform_test=CIFAR_TEST,
            kwargs={"depth": depth},
        )
    )


PreResNet8 = _cfg("PreResNet8", 8)
PreResNet20 = _cfg("PreResNet20", 20)
PreResNet56 = _cfg("PreResNet56", 56)
PreResNet83 = _cfg("PreResNet83", 83)
PreResNet110 = _cfg("PreResNet110", 110)
PreResNet164 = _cfg("PreResNet164", 164)
