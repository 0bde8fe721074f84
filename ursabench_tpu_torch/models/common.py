"""Model registry and the layers the model zoo shares.

Counterpart of ``ursabench_tpu/models/common.py``: a ``ModelCfg`` carries a
module factory and its ``ImageSpec`` transforms; ``get_model(name)`` looks it
up and ``dropout_twin(name)`` finds the ``<name>_dropout`` model MCdropout
samples with. ``BatchNorm2d`` here keeps flax's running statistics, not
torch's.

The layers take flax's compute ``dtype``: the parameters stay float32, and
a layer built with ``dtype=torch.bfloat16`` computes in bfloat16 (the conv
and the linear layer cast their input, kernel and bias, BatchNorm keeps
float32 statistics and returns bfloat16), as ``flax.linen.Conv``, ``Dense``
and ``BatchNorm`` do with ``dtype`` set. With ``dtype=None`` nothing is
cast: the layer computes in the type of what it is given, as flax promotes
its inputs.

``Dropout`` draws its mask from a ``torch.Generator`` that the caller binds
with ``dropout_generator(module, gen)``, never from the global RNG; an
active dropout layer without one raises.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional

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


def list_models():
    return sorted(_REGISTRY)


def dropout_twin(name: str) -> ModelCfg:
    """The ``<name>_dropout`` twin MCdropout samples with."""
    return get_model(name + "_dropout")


class Conv2d(nn.Conv2d):
    """An ``nn.Conv2d`` (bias-free unless ``bias``) that computes in
    ``dtype`` when it is set: the input, the float32 kernel and the bias are
    cast to it first."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: Optional[torch.dtype] = None,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        b = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), b)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` when it is set (flax
    ``Dense(dtype=...)``)."""

    def __init__(self, fin: int, fout: int, dtype: Optional[torch.dtype] = None):
        super().__init__(fin, fout)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability 1 - p and
    scale what is kept by 1/(1 - p). Active in training mode, and in eval
    mode too when ``always`` (flax's ``deterministic=False``, what the
    ``_dropout`` twins use). The mask comes from ``self.generator``, bound by
    ``dropout_generator``; the global RNG is never used."""

    def __init__(self, p: float, always: bool = False):
        super().__init__()
        self.p = float(p)
        self.always = always
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or not (self.training or self.always):
            return x
        if self.generator is None:
            raise RuntimeError("active Dropout without a generator: bind one with "
                               "models.common.dropout_generator(module, gen)")
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


def dropout_layers(module: nn.Module) -> list:
    return [m for m in module.modules() if isinstance(m, Dropout)]


@contextlib.contextmanager
def dropout_generator(module: nn.Module, gen: Optional[torch.Generator]) -> Iterator[None]:
    """Bind ``gen`` to every ``Dropout`` of ``module`` for the block (they
    draw from it in turn, in forward order) and unbind it after."""
    layers = dropout_layers(module)
    for m in layers:
        m.generator = gen
    try:
        yield
    finally:
        for m in layers:
            m.generator = None


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
