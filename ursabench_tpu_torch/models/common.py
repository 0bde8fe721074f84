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
active dropout layer without one raises. Under ``torch.func.vmap`` (chains
batched through one module, ``inference/engine.ChainForward``) nothing may
draw or write in place: each dropout layer then takes a mask drawn outside
(``dropout_masks``; ``dropout_calls`` finds the layers' input shapes) and
each BatchNorm layer returns its batch statistics instead of folding them
into its running ones (``batch_stats_out``).
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
    cast to it first, and the bias is added to the rounded convolution, as
    flax's ``Conv(dtype=...)`` adds it (a fused bias would round once, and
    the gradients would then drift from flax's by a second bf16 error)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: Optional[torch.dtype] = None,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        y = self._conv_forward(x.to(d), self.weight.to(d), None)
        return y if self.bias is None else y + self.bias.to(d).view(1, -1, 1, 1)


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
        self.mask: Optional[torch.Tensor] = None  # bound by dropout_masks
        self.calls: Optional[list] = None  # bound by dropout_calls

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or not (self.training or self.always):
            return x
        if self.calls is not None:  # a shape probe: record, draw nothing
            self.calls.append((self, tuple(x.shape)))
            return x
        keep = self.mask
        if keep is None:
            if self.generator is None:
                raise RuntimeError("active Dropout without a generator: bind one with "
                                   "models.common.dropout_generator(module, gen)")
            keep = self.draw(x.shape, self.generator)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))

    def draw(self, shape, gen: torch.Generator) -> torch.Tensor:
        """The keep mask of an input of ``shape`` from ``gen``."""
        return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - self.p


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


@torch.no_grad()
def dropout_calls(module: nn.Module, x: torch.Tensor) -> list:
    """``[(layer, input shape)]`` of every active dropout layer of
    ``module``, in the order its forward on ``x`` calls them: one forward
    with dropout as the identity and BatchNorm in eval mode (nothing is
    drawn or written)."""
    layers = dropout_layers(module)
    calls: list = []
    was_training = module.training
    for m in layers:
        m.calls = calls
    # eval mode keeps the running statistics; the twins' dropout stays on
    module.eval()
    for m in layers:
        m.train(was_training)
    try:
        module(x)
    finally:
        for m in layers:
            m.calls = None
        module.train(was_training)
    return calls


@contextlib.contextmanager
def dropout_masks(layers, masks) -> Iterator[None]:
    """Bind ``masks[i]`` to ``layers[i]`` for the block, then unbind."""
    for m, mask in zip(layers, masks):
        m.mask = mask
    try:
        yield
    finally:
        for m in layers:
            m.mask = None


@contextlib.contextmanager
def batch_stats_out(layers) -> Iterator[list]:
    """For the block, every ``BatchNorm2d`` of ``layers`` in training mode
    normalizes with its batch statistics and, in place of folding them into
    its running ones, leaves ``(mean, biased variance)`` (float32) in the
    list this yields, in ``layers``' order once the forward is done."""
    out: list = []
    for m in layers:
        m.stats_out = True
    try:
        yield out
        if any(m.training and m.batch_stats is None for m in layers):
            raise RuntimeError("a BatchNorm layer in training mode was not called")
        out.extend(m.batch_stats for m in layers if m.training)
    finally:
        for m in layers:
            m.stats_out, m.batch_stats = False, None


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
    computes them.

    Under ``batch_stats_out`` the training forward writes nothing: it
    normalizes with ``F.batch_norm`` over the batch alone and keeps the
    batch's mean and biased variance in ``batch_stats`` for the caller to
    fold (``engine.fold_batch_stats``), which is what ``torch.func.vmap``
    needs (an in-place write of one chain's statistics into a buffer shared
    by every chain raises there)."""

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
        self.stats_out = False
        self.batch_stats: Optional[tuple] = None

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
        if self.stats_out:
            # vmap's rule for a batched weight normalizes, then applies the
            # affine part in float32 (float64 stays): normalizing in float32
            # keeps one rounding
            x = x.to(torch.promote_types(x.dtype, torch.float32))
            out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.batch_stats = (mean, var)
            return out
        batch = torch.zeros(2, x.shape[1], dtype=self.running_mean.dtype, device=x.device)
        out = F.batch_norm(x, batch[0], batch[1], self.weight, self.bias,
                           True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(batch[0], alpha=m)
            self.running_var.mul_(1.0 - m).add_(batch[1], alpha=m * (n - 1) / n)
        return out
