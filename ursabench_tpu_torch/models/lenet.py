"""LeNet-5 for (Fashion)MNIST, NCHW.

Counterpart of ``ursabench_tpu/models/lenet.py`` (BASELINE.md config 2): the
28x28 input zero-padded to 32x32, two VALID 5x5 convs with bias, each
followed by ReLU and 2x2 average pooling, then three dense layers (120, 84,
classes), with torch's default initialisation (61,706 parameters at 10
classes). The features are flattened in flax's (H, W, C) order, so the
first dense kernel loads from flax unchanged. ``dtype`` is flax's compute
dtype (``models/common.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import MNIST_TEST, MNIST_TRAIN
from ..nn.init import torch_conv_, torch_linear_
from .common import Conv2d, Linear, ModelCfg, register


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, dtype=None):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.conv1 = Conv2d(1, 6, 5, dtype=dtype, bias=True)
        self.conv2 = Conv2d(6, 16, 5, dtype=dtype, bias=True)
        self.fc1 = Linear(16 * 5 * 5, 120, dtype)
        self.fc2 = Linear(120, 84, dtype)
        self.fc3 = Linear(84, num_classes, dtype)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's initialisation, drawn from ``gen``."""
        for m in (self.conv1, self.conv2):
            torch_conv_(m.weight, m.bias, gen)
        for m in (self.fc1, self.fc2, self.fc3):
            torch_linear_(m.weight, m.bias, gen)

    def forward(self, x):
        x = F.pad(x, (2, 2, 2, 2))
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = F.avg_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


LeNet5MNIST = register(
    ModelCfg(
        name="LeNet5MNIST",
        make=lambda num_classes, **kw: LeNet5(num_classes=num_classes, **kw),
        transform_train=MNIST_TRAIN,
        transform_test=MNIST_TEST,
    )
)
