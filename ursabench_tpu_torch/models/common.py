"""Model registry and the layers the model zoo shares.

Counterpart of ``ursabench_tpu/models/common.py``: a ``ModelCfg`` carries a
module factory and its ``ImageSpec`` transforms; ``get_model(name)`` looks it
up. ``BatchNorm2d`` here keeps flax's running statistics, not torch's.

Both layers take flax's compute ``dtype``: the parameters stay float32, and
a layer built with ``dtype=torch.bfloat16`` computes in bfloat16 (the conv
casts its input and kernel, BatchNorm keeps float32 statistics and returns
bfloat16), as ``flax.linen.Conv`` and ``BatchNorm`` do with ``dtype`` set.
With ``dtype=None`` nothing is cast: the layer computes in the type of what
it is given, as flax promotes its inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import ImageSpec

_REGISTRY: Dict[str, "ModelCfg"] = {}


@dataclass(frozen=True)
class ModelCfg:
    name: str
    make: Callable[..., nn.Module]  # make(num_classes, **kwargs) -> module
    transform_train: ImageSpec
    transform_test: ImageSpec
    kwargs: dict = field(default_factory=dict)

    def build(self, num_classes: int, **overrides) -> nn.Module:
        kw = {**self.kwargs, **overrides}
        return self.make(num_classes=num_classes, **kw)


def register(cfg: ModelCfg) -> ModelCfg:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_model(name: str) -> ModelCfg:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


class Conv2d(nn.Conv2d):
    """A bias-free ``nn.Conv2d`` that computes in ``dtype`` when it is set:
    the input and the float32 kernel are cast to it first."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        return self._conv_forward(x.to(d), self.weight.to(d), None)


class BatchNorm2d(nn.Module):
    """Batch normalization over NCHW with flax ``nn.BatchNorm`` semantics:
    the running variance averages the *biased* batch variance, and
    ``momentum`` is torch's convention (flax's 0.9 is 0.1 here):
    ``running = (1 - momentum) * running + momentum * batch``.

    ``torch.nn.BatchNorm2d`` keeps the unbiased variance instead, so the
    training forward lets ``F.batch_norm`` write the batch statistics into
    a scratch buffer (momentum 1) and folds them in with the n/(n-1)
    correction.

    With ``dtype`` set the output is cast to it; the statistics and the
    normalisation are computed in float32 whatever the input's type, as flax
    computes them."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._normalize(x)
        return out if self.compute_dtype is None else out.to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        batch = torch.zeros(2, x.shape[1], dtype=self.running_mean.dtype, device=x.device)
        out = F.batch_norm(x, batch[0], batch[1], self.weight, self.bias,
                           True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(batch[0], alpha=m)
            self.running_var.mul_(1.0 - m).add_(batch[1], alpha=m * (n - 1) / n)
        return out
