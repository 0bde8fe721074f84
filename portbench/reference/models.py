"""The reference models: pre-activation ResNet with basic blocks (He et al.,
"Identity Mappings in Deep Residual Networks", arXiv:1603.05027, as the
reference URSABench's ``models/preresnet.py`` builds it for CIFAR) and
WideResNet (Zagoruyko and Komodakis, "Wide Residual Networks",
arXiv:1605.07146), both NCHW, in float32.

PreResNet: a 3x3 stem of 16 channels without bias; three stages of basic
blocks at 16/32/64 channels, strides 1/2/2, each block BN-ReLU-conv3x3
(stride)-BN-ReLU-conv3x3 plus the input, or a 1x1 strided conv of the input
where the shape changes; BN-ReLU, global average pooling, a linear head.
Convolutions have no bias and draw N(0, 2/fan_out).

WideResNet-d-k: a 3x3 stem of 16 channels; three stages of (d-4)/6 wide
blocks at 16k/32k/64k channels, strides 1/2/2, each BN-ReLU-conv3x3-BN-
ReLU-conv3x3(stride) plus the input or a strided 1x1 conv of it; BN-ReLU,
pooling, a linear head. Every convolution has a bias; all weights draw
U(+-1/sqrt(fan_in)).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .layers import Leaf, Ops, Precision, Tensors, bn_leaves, conv_leaves, linear_leaves


def _preresnet_plan(depth: int, widths) -> List[tuple]:
    if (depth - 2) % 6 or depth >= 44:
        raise ValueError("basic-block PreResNet depth is 6n+2 below 44")
    n, plan, cin = (depth - 2) // 6, [], widths[0]
    for planes, stride in zip(widths, (1, 2, 2)):
        for i in range(n):
            s = stride if i == 0 else 1
            plan.append((cin, planes, s, s != 1 or cin != planes))
            cin = planes
    return plan


def _wideresnet_plan(depth: int, widths) -> List[tuple]:
    if (depth - 4) % 6:
        raise ValueError("WideResNet depth is 6n+4")
    n, plan, cin = (depth - 4) // 6, [], 16
    for planes, stride in zip(widths, (1, 2, 2)):
        for i in range(n):
            s = stride if i == 0 else 1
            plan.append((cin, planes, s, s != 1 or cin != planes))
            cin = planes
    return plan


class Model:
    """One of the two architectures at a configuration's sizes: ``leaves``
    (parameters in flat-buffer order, BatchNorm statistics among them) and
    ``forward(tensors, x, train, precision)`` -> float32 logits."""

    def __init__(self, cfg: dict):
        self.arch = cfg["reference"]
        self.depth, self.widths = int(cfg["depth"]), [int(w) for w in cfg["widths"]]
        self.image = tuple(int(v) for v in cfg["image"])  # (H, W, channels)
        self.num_classes, self.in_channels = int(cfg["num_classes"]), self.image[2]
        if self.arch == "preresnet":
            self.plan = _preresnet_plan(self.depth, self.widths)
        elif self.arch == "wideresnet":
            self.plan = _wideresnet_plan(self.depth, self.widths)
        else:
            raise ValueError(f"no reference model {self.arch!r}")
        self.leaves = self._leaves()

    def _leaves(self) -> List[Leaf]:
        out: List[Leaf] = []
        if self.arch == "preresnet":
            out += conv_leaves("conv1", self.in_channels, self.widths[0], 3, "fan_out_normal",
                               False)
            for i, (cin, planes, _, down) in enumerate(self.plan):
                b = f"blocks.{i}"
                out += bn_leaves(f"{b}.bn1", cin)
                if down:
                    out += conv_leaves(f"{b}.downsample", cin, planes, 1, "fan_out_normal", False)
                out += conv_leaves(f"{b}.conv1", cin, planes, 3, "fan_out_normal", False)
                out += bn_leaves(f"{b}.bn2", planes)
                out += conv_leaves(f"{b}.conv2", planes, planes, 3, "fan_out_normal", False)
        else:
            out += conv_leaves("conv1", self.in_channels, 16, 3, "uniform", True)
            for i, (cin, planes, _, short) in enumerate(self.plan):
                b = f"blocks.{i}"
                out += bn_leaves(f"{b}.bn1", cin)
                out += conv_leaves(f"{b}.conv1", cin, planes, 3, "uniform", True)
                out += bn_leaves(f"{b}.bn2", planes)
                out += conv_leaves(f"{b}.conv2", planes, planes, 3, "uniform", True)
                if short:
                    out += conv_leaves(f"{b}.shortcut", cin, planes, 1, "uniform", True)
        last = self.widths[-1]
        out += bn_leaves("bn", last)
        out += linear_leaves("fc", last, self.num_classes)
        return out

    @property
    def parameter_count(self) -> int:
        return sum(leaf.numel for leaf in self.leaves if not leaf.buffer)

    def forward(self, tensors: Tensors, x: torch.Tensor, train: bool,
                precision: Precision = Precision()) -> torch.Tensor:
        ops = Ops(tensors, train, precision)
        out = ops.conv("conv1", x)
        for i, (_, _, stride, changed) in enumerate(self.plan):
            b = f"blocks.{i}"
            if self.arch == "preresnet":
                h = F.relu(ops.bn(f"{b}.bn1", out))
                residual = ops.conv(f"{b}.downsample", out, stride, 0) if changed else out
                h = ops.conv(f"{b}.conv1", h, stride)
                out = ops.p.activation(ops.conv(f"{b}.conv2", F.relu(ops.bn(f"{b}.bn2", h)))
                                       + residual)
            else:
                h = ops.conv(f"{b}.conv1", F.relu(ops.bn(f"{b}.bn1", out)))
                h = ops.conv(f"{b}.conv2", F.relu(ops.bn(f"{b}.bn2", h)), stride)
                out = ops.p.activation(
                    h + (ops.conv(f"{b}.shortcut", out, stride, 0) if changed else out))
        out = F.relu(ops.bn("bn", out)).mean(dim=(2, 3))
        return ops.linear("fc", out)
