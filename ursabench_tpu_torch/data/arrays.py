"""Array-backed dataset splits.

Counterpart of ``ursabench_tpu/data/arrays.py``: a split is the whole set as
one uint8 NHWC array and int64 labels on the host. Samplers and tasks move
it to the device once (``device_tensors``) and gather batches there. The
images may be a read-only memmap (a synthetic-cache hit): a tensor made of
them is then a copy, never a view torch could write through (on the CPU a
host copy, on another device the host-to-device copy itself).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from .transforms import ImageSpec, normalize


def device_tensor(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``. On the CPU it is a view of a
    writable contiguous array, else a copy (a tensor must not alias
    read-only memory). On another device the host-to-device copy is the
    only copy: a read-only array is wrapped for that copy alone, so no
    tensor is left aliasing it."""
    a = np.ascontiguousarray(a)
    if a.flags.writeable:
        return torch.from_numpy(a).to(device)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(a.copy())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a).to(device)


@dataclass
class DataSplit:
    images: np.ndarray  # uint8 NHWC
    labels: np.ndarray  # int64
    batch_size: int
    spec: ImageSpec  # transform applied when batches are drawn
    shuffle: bool = False
    dataset_name: str = ""

    def __post_init__(self):
        if self.images.ndim != 4 or self.images.dtype != np.uint8:
            raise ValueError(
                f"images must be uint8 NHWC, got {self.images.dtype} "
                f"{self.images.shape}")
        self.labels = np.asarray(self.labels, np.int64)

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def n(self) -> int:
        return self.images.shape[0]

    @property
    def num_batches(self) -> int:
        return -(-self.n // self.batch_size)

    def device_tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole split on ``device``: uint8 NHWC images, int64 labels."""
        return device_tensor(self.images, device), device_tensor(self.labels, device)

    def batches(self, device, normalized: bool = True
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Sequential NHWC batches on ``device``, without shuffling or
        augmentation; the last one short."""
        for i in range(0, self.n, self.batch_size):
            x = device_tensor(self.images[i: i + self.batch_size], device)
            if normalized:
                x = normalize(x, self.spec)
            y = device_tensor(self.labels[i: i + self.batch_size], device)
            yield x, y
