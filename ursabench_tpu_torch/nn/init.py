"""Weight initializers of the reference model zoo, drawn from an explicit
CPU ``torch.Generator`` and copied into the tensor, so a run's initial
weights do not depend on the device the model lives on.

Counterpart of ``ursabench_tpu/nn/init.py``:
- PreResNet and TVResNet convs: N(0, sqrt(2/(kh*kw*out_channels))), fan-out
  scaling.
- INResNet convs and head: ``kaiming_normal``, N(0, sqrt(2/fan_in)).
- Linear kernel and bias: torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
- WideResNet convs, kernel and bias: the same torch default.
"""

from __future__ import annotations

import math

import torch


def _host(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


@torch.no_grad()
def fan_out_normal_(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """In place: N(0, sqrt(2/fan_out)) for an OIHW conv kernel."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    draw = _host(weight).normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
    return weight.copy_(draw)


@torch.no_grad()
def kaiming_normal_(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """In place: N(0, sqrt(2/fan_in)) for an OIHW conv kernel or an (out,
    in) linear kernel."""
    fan_in = weight[0].numel()
    draw = _host(weight).normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    return weight.copy_(draw)


@torch.no_grad()
def torch_linear_bias_(bias: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """In place: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    bias.copy_(_host(bias).uniform_(-bound, bound, generator=gen))


@torch.no_grad()
def torch_linear_(weight: torch.Tensor, bias: torch.Tensor | None,
                  gen: torch.Generator) -> None:
    """In place: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for an (out, in) kernel
    and its bias."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    weight.copy_(_host(weight).uniform_(-bound, bound, generator=gen))
    if bias is not None:
        torch_linear_bias_(bias, weight.shape[1], gen)


@torch.no_grad()
def torch_conv_(weight: torch.Tensor, bias: torch.Tensor | None,
                gen: torch.Generator) -> None:
    """In place: torch's default for an OIHW conv, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for the kernel and its bias, fan_in = in * kh * kw (the
    value WideResNet's flax convs pass to their bias initialiser)."""
    fan_in = weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    weight.copy_(_host(weight).uniform_(-bound, bound, generator=gen))
    if bias is not None:
        torch_linear_bias_(bias, fan_in, gen)
