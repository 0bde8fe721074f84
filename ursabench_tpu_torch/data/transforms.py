"""Image preprocessing specs and on-device augmentation.

Counterpart of ``ursabench_tpu/data/transforms.py``. Batches stay NHWC, the
JAX package's layout, so the two can be compared directly; the engine
permutes to NCHW just before the model. Crop and flip index the padded
batch directly. The random choices are explicit tensors that the caller
draws from its ``torch.Generator`` (``draw_augment``), so a test can hand in
the choices the JAX package drew.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ImageSpec:
    size: int
    channels: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    random_crop_pad: int = 0
    random_flip: bool = False

    @property
    def shape(self):
        return (self.size, self.size, self.channels)

    @property
    def augments(self) -> bool:
        return self.random_crop_pad > 0 or self.random_flip


MNIST_TRAIN = ImageSpec(28, 1, (0.1307,), (0.3081,))
MNIST_TEST = MNIST_TRAIN

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)
CIFAR_TRAIN = ImageSpec(32, 3, CIFAR_MEAN, CIFAR_STD, random_crop_pad=4, random_flip=True)
CIFAR_TEST = ImageSpec(32, 3, CIFAR_MEAN, CIFAR_STD)

# ImageNet 224^2 normalization, the reference's trtprof input pipeline
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGENET_TRAIN = ImageSpec(224, 3, IMAGENET_MEAN, IMAGENET_STD, random_flip=True)
IMAGENET_TEST = ImageSpec(224, 3, IMAGENET_MEAN, IMAGENET_STD)


@functools.lru_cache(maxsize=64)
def _channel_consts(spec: ImageSpec, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and std on ``device``, made once: a fresh host ->
    device copy on every batch would synchronise the stream each step."""
    mean = torch.tensor(spec.mean, dtype=torch.float32, device=device)
    std = torch.tensor(spec.std, dtype=torch.float32, device=device)
    return mean, std


def normalize(images: torch.Tensor, spec: ImageSpec) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NHWC ((x/255 - mean)/std)."""
    mean, std = _channel_consts(spec, images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std


def draw_augment(gen: torch.Generator, shape, spec: ImageSpec):
    """Per-image crop offsets and flips for a batch of ``shape`` (e.g.
    ``(num_batches, batch_size)``), drawn from ``gen`` on its device:
    ``(ox, oy, flip)`` with offsets in ``[0, 2*pad]`` (None without a crop)
    and a bool flip (None without flipping)."""
    ox = oy = flip = None
    device = gen.device
    if spec.random_crop_pad > 0:
        hi = 2 * spec.random_crop_pad + 1
        ox = torch.randint(0, hi, shape, generator=gen, device=device)
        oy = torch.randint(0, hi, shape, generator=gen, device=device)
    if spec.random_flip:
        flip = torch.rand(shape, generator=gen, device=device) < 0.5
    return ox, oy, flip


def augment(x: torch.Tensor, spec: ImageSpec, ox: Optional[torch.Tensor],
            oy: Optional[torch.Tensor], flip: Optional[torch.Tensor],
            pad_value: torch.Tensor) -> torch.Tensor:
    """torchvision ``RandomCrop(size, padding=pad)`` then
    ``RandomHorizontalFlip`` on an NHWC batch, with explicit choices:
    crop row ``i`` of image ``n`` reads padded row ``ox[n] + i`` and crop
    column ``j`` reads padded column ``oy[n] + j`` (``w-1-j`` when flipped).
    The border takes ``pad_value`` per channel."""
    n, h, w, c = x.shape
    if spec.random_crop_pad > 0:
        p = spec.random_crop_pad
        padded = pad_value.to(x.dtype).expand(n, h + 2 * p, w + 2 * p, c).clone()
        padded[:, p:p + h, p:p + w, :] = x
        cols = torch.arange(w, device=x.device).expand(n, w)
        if flip is not None:
            cols = torch.where(flip[:, None], w - 1 - cols, cols)
        rows = ox[:, None] + torch.arange(h, device=x.device)
        cols = oy[:, None] + cols
        batch = torch.arange(n, device=x.device)[:, None, None]
        return padded[batch, rows[:, :, None], cols[:, None, :]]
    if flip is not None:
        return torch.where(flip[:, None, None, None], x.flip(2), x)
    return x


def augment_normalized(x: torch.Tensor, spec: ImageSpec, ox, oy, flip) -> torch.Tensor:
    """Augment an already-normalized f32 batch, with the crop border at the
    normalized value of a zero pixel ((0 - mean)/std), so the result equals
    torchvision's pad-before-normalize pipeline."""
    mean, std = _channel_consts(spec, x.device)
    return augment(x, spec, ox, oy, flip, pad_value=-mean / std)
