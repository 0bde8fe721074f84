"""Functional layers of the reference models, and the precisions they run in.

A model is a list of leaves (``Leaf``: name, shape, how it is initialised)
and a forward over a dict of tensors keyed by those names. The names are
the parameter and buffer names the served model's ``state_dict`` uses, and
the parameters come in the order of the served model's flat parameter
buffer, which is the order SGHMC's noise is drawn in.

BatchNorm follows flax: training normalizes with the batch's biased
variance; evaluation with the running statistics.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    # "fan_out_normal": N(0, 2/fan_out); "uniform": U(+-1/sqrt(fan_in));
    # "ones", "zeros"
    init: str
    fan_in: int = 1
    fan_out: int = 1
    buffer: bool = False  # a BatchNorm running statistic, not a parameter

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def std(self) -> float:
        """The standard deviation of the leaf's initial distribution."""
        if self.init == "fan_out_normal":
            return math.sqrt(2.0 / self.fan_out)
        if self.init == "uniform":
            return 1.0 / math.sqrt(self.fan_in) / math.sqrt(3.0)
        return 0.0


def conv_leaves(name: str, cin: int, cout: int, k: int, init: str, bias: bool) -> List[Leaf]:
    fan_in, fan_out = cin * k * k, cout * k * k
    out = [Leaf(f"{name}.weight", (cout, cin, k, k), init, fan_in, fan_out)]
    if bias:
        out.append(Leaf(f"{name}.bias", (cout,), "uniform", fan_in, fan_out))
    return out


def bn_leaves(name: str, c: int) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (c,), "ones"), Leaf(f"{name}.bias", (c,), "zeros"),
            Leaf(f"{name}.running_mean", (c,), "zeros", buffer=True),
            Leaf(f"{name}.running_var", (c,), "ones", buffer=True)]


def linear_leaves(name: str, fin: int, fout: int) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (fout, fin), "uniform", fin, fout),
            Leaf(f"{name}.bias", (fout,), "uniform", fin, fout)]


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` under one scale that maps its
    largest magnitude to ``top``, back in ``t``'s type."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding: the value to e4m3, its gradient to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


class Precision:
    """How the reference's convolutions and matrix products compute.

    ``"fp32"``: float32, TF32 off. ``"tf32"``: float32 inputs, TF32 on in
    cuDNN and cuBLAS. ``"fp8"``: every convolution's and matrix product's
    input and weight rounded to float8 e4m3 with one scale a tensor (its
    largest magnitude mapped to 448), then computed in float32, as an fp8
    path with per-tensor scales and float32 accumulation computes, and the
    activations rounded so wherever a bf16 model keeps them in bf16 (each
    convolution's and BatchNorm's output and each residual sum); in the
    backward the gradient of each of them is rounded to float8 e5m2 with
    one scale a tensor (its largest magnitude mapped to 57344), as fp8
    training keeps gradients."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A convolution's or matrix product's input or weight."""
        return _Fp8.apply(t) if self.name == "fp8" else t

    # a bf16 model's activations (a convolution's output, a BatchNorm's, a
    # residual sum) are rounded where it stores them; fp8 rounds them there too
    activation = operand

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


class Ops:
    """The layers over one dict of tensors, in one precision and mode."""

    def __init__(self, tensors: Tensors, train: bool, precision: Precision):
        self.t, self.train, self.p = tensors, train, precision

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, pad: Optional[int] = None
             ) -> torch.Tensor:
        w = self.t[f"{name}.weight"]
        pad = w.shape[-1] // 2 if pad is None else pad
        y = F.conv2d(self.p.operand(x), self.p.operand(w), None, stride, pad)
        b = self.t.get(f"{name}.bias")
        return self.p.activation(y if b is None else y + b.view(1, -1, 1, 1))

    def bn(self, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        w, b = self.t[f"{name}.weight"], self.t[f"{name}.bias"]
        if self.train:
            y = F.batch_norm(x, None, None, w, b, True, 0.0, eps)
        else:
            y = F.batch_norm(x, self.t[f"{name}.running_mean"], self.t[f"{name}.running_var"],
                             w, b, False, 0.0, eps)
        return self.p.activation(y)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.p.operand(x), self.p.operand(self.t[f"{name}.weight"]),
                        self.t[f"{name}.bias"])


def parameter_leaves(leaves: List[Leaf]) -> List[Leaf]:
    return [leaf for leaf in leaves if not leaf.buffer]
