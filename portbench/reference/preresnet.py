"""Pre-activation ResNet with basic blocks (He et al., "Identity Mappings in
Deep Residual Networks", arXiv:1603.05027, as the reference URSABench's
``models/preresnet.py`` builds it for CIFAR), NCHW, in float32.

A 3x3 stem of 16 channels without bias; three stages of basic blocks at
16/32/64 channels, strides 1/2/2, each block BN-ReLU-conv3x3(stride)-BN-
ReLU-conv3x3 plus the input, or a 1x1 strided conv of the input where the
shape changes; BN-ReLU, global average pooling, a linear head. Convolutions
have no bias and draw N(0, 2/fan_out).

Found by name (``"reference": "preresnet"``), so it imports absolutely.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from portbench.reference.images import ImageClassifier
from portbench.reference.layers import (Leaf, Ops, Precision, Tensors, bn_leaves, conv_leaves,
                                        linear_leaves)


def _plan(depth: int, widths) -> List[tuple]:
    if (depth - 2) % 6 or depth >= 44:
        raise ValueError("basic-block PreResNet depth is 6n+2 below 44")
    n, plan, cin = (depth - 2) // 6, [], widths[0]
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
        out: List[Leaf] = conv_leaves("conv1", self.in_channels, self.widths[0], 3,
                                      "fan_out_normal", False)
        for i, (cin, planes, _, down) in enumerate(self.plan):
            b = f"blocks.{i}"
            out += bn_leaves(f"{b}.bn1", cin)
            if down:
                out += conv_leaves(f"{b}.downsample", cin, planes, 1, "fan_out_normal", False)
            out += conv_leaves(f"{b}.conv1", cin, planes, 3, "fan_out_normal", False)
            out += bn_leaves(f"{b}.bn2", planes)
            out += conv_leaves(f"{b}.conv2", planes, planes, 3, "fan_out_normal", False)
        out += bn_leaves("bn", self.widths[-1])
        out += linear_leaves("fc", self.widths[-1], self.num_classes)
        self.leaves = out

    def forward(self, tensors: Tensors, x: torch.Tensor, train: bool,
                precision: Precision = Precision()) -> torch.Tensor:
        ops = Ops(tensors, train, precision)
        out = ops.conv("conv1", x)
        for i, (_, _, stride, changed) in enumerate(self.plan):
            b = f"blocks.{i}"
            h = F.relu(ops.bn(f"{b}.bn1", out))
            residual = ops.conv(f"{b}.downsample", out, stride, 0) if changed else out
            h = ops.conv(f"{b}.conv1", h, stride)
            out = ops.p.activation(ops.conv(f"{b}.conv2", F.relu(ops.bn(f"{b}.bn2", h)))
                                   + residual)
        out = F.relu(ops.bn("bn", out)).mean(dim=(2, 3))
        return ops.linear("fc", out)
