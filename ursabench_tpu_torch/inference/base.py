"""Sampler protocol: the constructor takes (hyperparameters, model, train
split); ``update_hyp`` re-initialises; ``sample_iterative`` returns one
posterior draw; ``sample`` returns the ``Ensemble``.

Counterpart of ``ursabench_tpu/inference/base.py`` without the device mesh
and checkpointing. Randomness comes from ``seed`` through generators seeded
with sha256-derived sub-seeds, one per purpose, where the JAX package splits
a PRNG key.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..util import derive_seed
from .ensemble import Ensemble


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (CUDA when None). Raises when CUDA
    is asked for and absent: nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


class _Inference:
    def __init__(
        self,
        hyperparameters: Optional[dict],
        model=None,  # torch module
        train=None,  # DataSplit
        model_loss: str = "multi_class_linear_output",
        seed: int = 0,
        chains: int = 1,
        device=None,
    ):
        if model_loss != "multi_class_linear_output":
            raise NotImplementedError(model_loss)
        if int(chains) != 1:
            raise NotImplementedError(
                "chains > 1 is not ported yet (ROADMAP.md open item 7)")
        self.device = resolve_device(device)
        self.module = model.to(self.device)
        self.train = train
        self.model_loss = model_loss
        self.seed = int(seed)
        self.chains = 1
        self.hyperparameters = hyperparameters
        self._draws = 0

    # -- protocol ------------------------------------------------------------

    def update_hyp(self, hyperparameters: dict):
        raise NotImplementedError

    def sample_iterative(self):
        raise NotImplementedError

    def sample(self, num_samples: Optional[int] = None) -> Ensemble:
        raise NotImplementedError

    # -- shared helpers --------------------------------------------------------

    def next_seed(self) -> int:
        """A fresh sub-seed of ``seed`` (the counterpart of splitting the
        sampler's PRNG key)."""
        self._draws += 1
        return derive_seed(self.seed, "draw", self._draws)
