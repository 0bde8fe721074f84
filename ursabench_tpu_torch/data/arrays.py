"""Array-backed dataset splits.

Counterpart of ``ursabench_tpu/data/arrays.py``: a split is the whole set as
one uint8 NHWC array and int64 labels on the host. Samplers and tasks move
it to the device once (``device_tensors``) and gather batches there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from .transforms import ImageSpec, normalize


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
        images = torch.from_numpy(np.ascontiguousarray(self.images))
        labels = torch.from_numpy(self.labels)
        return images.to(device), labels.to(device)

    def batches(self, device, normalized: bool = True
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Sequential NHWC batches on ``device``, without shuffling or
        augmentation; the last one short."""
        for i in range(0, self.n, self.batch_size):
            x = torch.from_numpy(
                np.ascontiguousarray(self.images[i: i + self.batch_size])
            ).to(device)
            if normalized:
                x = normalize(x, self.spec)
            y = torch.from_numpy(self.labels[i: i + self.batch_size]).to(device)
            yield x, y
