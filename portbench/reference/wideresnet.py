"""WideResNet (Zagoruyko and Komodakis, "Wide Residual Networks",
arXiv:1605.07146, as the reference URSABench's ``models/wide_resnet.py``
builds it, without dropout), NCHW, in float32.

WideResNet-d-k: a 3x3 stem of 16 channels; three stages of (d-4)/6 wide
blocks at 16k/32k/64k channels, strides 1/2/2, each BN-ReLU-conv3x3-BN-
ReLU-conv3x3(stride) plus the input or a strided 1x1 conv of it; BN-ReLU,
pooling, a linear head. Every convolution has a bias; all weights draw
U(+-1/sqrt(fan_in)).

Found by name (``"reference": "wideresnet"``), so it imports absolutely.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from portbench.reference.images import ImageClassifier
from portbench.reference.layers import (Leaf, Ops, Precision, Tensors, bn_leaves, conv_leaves,
                                        linear_leaves)


def _plan(depth: int, widths) -> List[tuple]:
    if (depth - 4) % 6:
        raise ValueError("WideResNet depth is 6n+4")
    n, plan, cin = (depth - 4) // 6, [], 16
    for planes, stride in zip(widths, (1, 2, 2)):
        for i in range(n):
            s = stride if i == 0 else 1
            plan.append((cin, planes, s, s != 1 or cin != planes))
            cin = planes
    return plan


class Architecture(ImageClassifier):
    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.depth, self.widths = int(cfg["depth"]), [int(w) for w in cfg["widths"]]
        self.plan = _plan(self.depth, self.widths)
        out: List[Leaf] = conv_leaves("conv1", self.in_channels, 16, 3, "uniform", True)
        for i, (cin, planes, _, short) in enumerate(self.plan):
            b = f"blocks.{i}"
            out += bn_leaves(f"{b}.bn1", cin)
            out += conv_leaves(f"{b}.conv1", cin, planes, 3, "uniform", True)
            out += bn_leaves(f"{b}.bn2", planes)
            out += conv_leaves(f"{b}.conv2", planes, planes, 3, "uniform", True)
            if short:
                out += conv_leaves(f"{b}.shortcut", cin, planes, 1, "uniform", True)
        out += bn_leaves("bn", self.widths[-1])
        out += linear_leaves("fc", self.widths[-1], self.num_classes)
        self.leaves = out

    def forward(self, tensors: Tensors, x: torch.Tensor, train: bool,
                precision: Precision = Precision()) -> torch.Tensor:
        ops = Ops(tensors, train, precision)
        out = ops.conv("conv1", x)
        for i, (_, _, stride, changed) in enumerate(self.plan):
            b = f"blocks.{i}"
            h = ops.conv(f"{b}.conv1", F.relu(ops.bn(f"{b}.bn1", out)))
            h = ops.conv(f"{b}.conv2", F.relu(ops.bn(f"{b}.bn2", h)), stride)
            out = ops.p.activation(
                h + (ops.conv(f"{b}.shortcut", out, stride, 0) if changed else out))
        out = F.relu(ops.bn("bn", out)).mean(dim=(2, 3))
        return ops.linear("fc", out)
