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

Activations are (N, C, H, W) tensors. A conv whose compute dtype is a
16-bit float runs them channels-last (NHWC in memory) on a CUDA device: it
casts its input and its kernel with ``memory_format=torch.channels_last``,
which cuDNN's 16-bit tensor-core convolutions read without a transpose, and
everything after it (the bias add, ReLU, the residual add, ``BatchNorm2d``)
keeps that format. There a 1x1 conv that narrows its channels casts to NCHW
instead: cuDNN's NHWC weight gradient of such a conv can round further from
float32 than its NCHW one (on an H100 at batch 128, six of ResNet-50's
fifteen read 1.2-4.1x ``chip_smoke.py``'s 2-ulp bound, against 0.26-0.44x
in NCHW), where every other conv of ResNet-50 and WideResNet-28-10 reads
within half the bound in both. A float32 conv, a conv on another device, or
one called under a ``torch.func`` transform (whose batched tensors cannot be
channels-last) keeps its input's format, NCHW from the data path.
``tracing``'s ``conv.layout`` counts the calls of each.

In eval mode a bf16 WideResNet block's epilogue, each BatchNorm with its
ReLU, the conv biases and the residual add, runs as the two fused kernels of
``kernels/eval_epilogue.py`` where ``eval_epilogue_fused`` finds that it
applies (on the card, channels-last, autograd off, no transform, no active
dropout); ``Conv2d.convolve`` gives the convolution without its bias for
it. ``tracing``'s ``bn.eval`` counts each eval-mode 16-bit BatchNorm call
by the path it took.

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

from .. import tracing
from ..data.transforms import ImageSpec

_REGISTRY: Dict[str, "ModelCfg"] = {}
_CHANNELS_LAST_DTYPES = (torch.bfloat16, torch.float16)
# the device types whose 16-bit convs run channels-last. Not the CPU: the
# CPU's channels-last BatchNorm, float32 inside as the NCHW one, flips other
# bf16 roundings, and in training mode that carries a small ResNet's logits
# past the CPU parity tests' bound from its float32 forward, which the NCHW
# forward meets on their input with little room
_CHANNELS_LAST_DEVICES = ("cuda",)


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
    the gradients would then drift from flax's by a second bf16 error).

    A 16-bit ``dtype`` casts the input and the kernel in the memory format
    ``memory_format`` gives (the module docstring); the float32 parameter
    keeps its layout, and autograd adds the kernel gradient into its
    ``.grad`` in place."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: Optional[torch.dtype] = None,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def memory_format(self, x: torch.Tensor) -> torch.memory_format:
        """The memory format this conv runs ``x`` in: channels-last, NCHW
        (``contiguous_format``), or ``x``'s own (``preserve_format``)."""
        if (self.compute_dtype not in _CHANNELS_LAST_DTYPES
                or x.device.type not in _CHANNELS_LAST_DEVICES
                or torch._C._functorch.peek_interpreter_stack() is not None):
            return torch.preserve_format
        if self.kernel_size == (1, 1) and self.in_channels > self.out_channels:
            return torch.contiguous_format
        return torch.channels_last

    def _counted_format(self, x: torch.Tensor) -> torch.memory_format:
        """``memory_format(x)``, counted in ``tracing``'s ``conv.layout``."""
        fmt = self.memory_format(x)
        tracing.conv_layout("channels_last" if fmt == torch.channels_last else "nchw")
        return fmt

    def convolve(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution in ``dtype``, rounded to it, without the bias:
        ``forward`` less its bias add (``dtype`` set)."""
        d, fmt = self.compute_dtype, self._counted_format(x)
        return self._conv_forward(x.to(d, memory_format=fmt), self.weight.to(d, memory_format=fmt),
                                  None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d is None:
            self._counted_format(x)
            return super().forward(x)
        y = self.convolve(x)
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

    @property
    def active(self) -> bool:
        """Whether a forward now drops anything."""
        return self.p != 0.0 and (self.training or self.always)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active:
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
    """Batch normalization over (N, C, H, W), in either memory format, with
    flax ``nn.BatchNorm`` semantics: the running variance averages the
    *biased* batch variance, and ``momentum`` is torch's convention (flax's
    0.9 is 0.1 here):
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
        if not self.training and self.compute_dtype in _CHANNELS_LAST_DTYPES:
            tracing.bn_eval("unfused")
        out = self._normalize(x)
        return out if self.compute_dtype is None else out.to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # a bfloat16 input normalized in float32, as the mixed-dtype call
            # computes it; under vmap (stacked members' statistics) the batch
            # rule needs the input in the statistics' dtype
            x = x.to(torch.promote_types(x.dtype, self.running_mean.dtype))
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


def eval_epilogue_fused(x: torch.Tensor, bns, dropout: Optional[Dropout] = None) -> bool:
    """Whether the eval-mode epilogue that starts from the activation ``x``
    (the ``BatchNorm2d`` layers ``bns``, each with its ReLU, and the bias
    and residual adds around them: a WideResNet block, or its head) runs as
    ``kernels/eval_epilogue.py``'s fused kernels, which compute what the
    layers compute, rounded at the same points. It does where nothing needs
    the unfused ops: autograd records nothing, no ``torch.func`` transform
    or compiler traces the forward, every BN is in eval mode and computes
    in bf16, ``dropout`` (the epilogue's dropout layer, or None) drops
    nothing, and ``x`` is a plain bf16 tensor, channels-last contiguous, on
    a device whose 16-bit convs run channels-last (the card). The fused
    ``bns`` count in ``tracing``'s ``bn.eval``; unfused, each BN counts
    itself."""
    if (torch.is_grad_enabled() or x.dtype != torch.bfloat16 or type(x) is not torch.Tensor
            or x.device.type not in _CHANNELS_LAST_DEVICES
            or torch._C._functorch.peek_interpreter_stack() is not None
            or torch.compiler.is_compiling()
            or any(bn.training or bn.compute_dtype != torch.bfloat16 for bn in bns)
            or (dropout is not None and dropout.active)
            or not x.is_contiguous(memory_format=torch.channels_last)):
        return False
    tracing.bn_eval("fused", len(bns))
    return True
