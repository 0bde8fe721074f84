"""WideResNet-28x10 and its always-on-dropout twin, on (N, C, H, W) batches.

Counterpart of ``ursabench_tpu/models/wideresnet.py``: pre-activation wide
basic blocks (BN, ReLU, 3x3 conv, [dropout,] BN, ReLU, strided 3x3 conv,
plus a strided 1x1 conv shortcut when the shape changes); every conv has a
bias, and kernels and biases take torch's default initialisation. BatchNorm
momentum is flax's 0.9 in the blocks (0.1 here, torch's convention) and
flax's 0.1 in the head (0.9 here). Global average pooling and the head run
in float32; ``dtype`` is flax's compute dtype (``models/common.py``). With
a 16-bit ``dtype`` the stem's conv turns the batch channels-last and every
activation after it stays so, up to the pooled (N, C) features. In eval mode
on the card, a bf16 block runs its epilogue (BN-ReLU twice, the conv
biases, the residual add) as ``kernels/eval_epilogue.py``'s two fused
kernels, and the head its BN-ReLU, where ``common.eval_epilogue_fused``
finds that they apply; elsewhere the same ops run unfused.

The ``_dropout`` twins put dropout 0.1 in every block and on the pooled
features, active in eval mode too (flax ``deterministic=False``), which is
what MCdropout samples with.

Children are registered in the order flax creates them, per layer type:
the stem ``Conv_0``, the blocks ``WideBasic_k`` (each ``BatchNorm_0,
Conv_0, [Dropout_0,] BatchNorm_1, Conv_1``, then the shortcut ``Conv_2``),
``BatchNorm_0``, ``[Dropout_0,]`` ``Dense_0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import CIFAR_TEST, CIFAR_TRAIN
from ..nn.init import torch_conv_, torch_linear_
from ..kernels.eval_epilogue import bias_residual_add, fused_batchnorm_eval_relu
from .common import BatchNorm2d, Conv2d, Dropout, ModelCfg, eval_epilogue_fused, register


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, dtype=None) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, kernel // 2, dtype, bias=True)


class WideBasic(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dropout_rate: float = 0.0, mc_dropout: bool = False, dtype=None):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes, momentum=0.1, dtype=dtype)
        self.conv1 = _conv(in_planes, planes, 3, 1, dtype)
        self.dropout = Dropout(dropout_rate, always=mc_dropout) if dropout_rate > 0 else None
        self.bn2 = BatchNorm2d(planes, momentum=0.1, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, stride, dtype)
        self.shortcut = (_conv(in_planes, planes, 1, stride, dtype)
                         if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        if eval_epilogue_fused(x, (self.bn1, self.bn2), self.dropout):
            return self._fused_forward(x)
        out = self.conv1(F.relu(self.bn1(x)))
        if self.dropout is not None:
            out = self.dropout(out)
        out = self.conv2(F.relu(self.bn2(out)))
        return out + (x if self.shortcut is None else self.shortcut(x))

    def _fused_forward(self, x):
        """``forward`` in eval mode with its epilogue fused: the convs'
        biases are added inside the kernels that read their outputs."""
        h = self.conv1.convolve(_bn_relu(self.bn1, x))
        h = self.conv2.convolve(_bn_relu(self.bn2, h, self.conv1.bias))
        if self.shortcut is None:
            return bias_residual_add(h, self.conv2.bias, x)
        return bias_residual_add(h, self.conv2.bias, self.shortcut.convolve(x), self.shortcut.bias)


def _bn_relu(bn: BatchNorm2d, t, conv_bias=None):
    return fused_batchnorm_eval_relu(t, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                     bn.eps, conv_bias)


class WideResNet(nn.Module):
    """``dropout_rate``: dropout in the blocks, training mode only;
    ``dropout`` (the twin): dropout in the blocks and on the pooled
    features, always active."""

    def __init__(self, depth: int = 28, widen_factor: int = 10, num_classes: int = 10,
                 dropout_rate: float = 0.0, dropout: float = 0.0, dtype=None,
                 in_channels: int = 3):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError("Wide-resnet depth should be 6n+4")
        n, k = (depth - 4) // 6, widen_factor
        mc = dropout > 0
        self.num_classes, self.dtype = num_classes, dtype
        self.conv1 = _conv(in_channels, 16, 3, dtype=dtype)
        blocks, in_planes = [], 16
        for planes, stride in zip((16 * k, 32 * k, 64 * k), (1, 2, 2)):
            for i in range(n):
                blocks.append(WideBasic(in_planes, planes, stride if i == 0 else 1,
                                        dropout if mc else dropout_rate, mc, dtype))
                in_planes = planes
        self.blocks = nn.ModuleList(blocks)
        self.bn = BatchNorm2d(in_planes, momentum=0.9, dtype=dtype)
        self.dropout = Dropout(dropout, always=True) if mc else None
        self.fc = nn.Linear(in_planes, num_classes)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's initialisation, drawn from ``gen``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                torch_conv_(m.weight, m.bias, gen)
            elif isinstance(m, nn.Linear):
                torch_linear_(m.weight, m.bias, gen)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        out = self.conv1(x)
        for blk in self.blocks:
            out = blk(out)
        out = (_bn_relu(self.bn, out) if eval_epilogue_fused(out, (self.bn,), self.dropout)
               else F.relu(self.bn(out)))
        out = out.to(torch.float32).mean(dim=(2, 3))
        if self.dropout is not None:
            out = self.dropout(out)
        return self.fc(out)


def _cfg(name: str, dropout: float = 0.0) -> ModelCfg:
    return register(
        ModelCfg(
            name=name,
            make=lambda num_classes, **kw: WideResNet(num_classes=num_classes, **kw),
            transform_train=CIFAR_TRAIN,
            transform_test=CIFAR_TEST,
            kwargs={"depth": 28, "widen_factor": 10,
                    **({"dropout": dropout} if dropout else {})},
        )
    )


WideResNet28x10 = _cfg("WideResNet28x10")
WideResNet28x10_dropout = _cfg("WideResNet28x10_dropout", 0.1)
WideResNet_dropout = _cfg("WideResNet_dropout", 0.1)  # the reference's alias
