"""What every reference architecture gives the harness.

A configuration names its architecture under ``"reference"``: the module
``reference/<name>.py``, which the harness's registry finds under its roots,
the package's own last (``core.Registry.model``), so an architecture is
added by adding a file. The module's class ``Architecture(cfg)`` is a
``Model``: its leaves at the configuration's sizes, its forward, an example
input and target on the meta device (what the FLOP count feeds), the rows of
a training step prepared as the step sees them, and its loss.

This package's own: ``preresnet`` and ``wideresnet`` (image classifiers,
``images.ImageClassifier``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .layers import Leaf, Precision, Tensors


class Model:
    """One architecture at one configuration's sizes.

    ``leaves``: its parameters in the served model's flat-buffer order (the
    order SGHMC's noise is drawn in), its buffers (BatchNorm statistics)
    among them."""

    leaves: List[Leaf]

    @property
    def parameter_count(self) -> int:
        return sum(leaf.numel for leaf in self.leaves if not leaf.buffer)

    def forward(self, tensors: Tensors, x: torch.Tensor, train: bool,
                precision: Precision = Precision()) -> torch.Tensor:
        """float32 logits of the batch ``x`` under the leaves ``tensors``
        (by name), in train or eval mode, computed in ``precision``."""
        raise NotImplementedError

    def example(self, batch: int, device="meta") -> Tuple[torch.Tensor, torch.Tensor]:
        """An input and a target of ``batch`` rows, as ``train_batch`` gives
        them, on ``device``: the shapes the FLOP count feeds."""
        raise NotImplementedError

    def train_batch(self, inputs: torch.Tensor, labels: torch.Tensor, draws: dict,
                    i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The input and target of step ``i`` of a chain's first epoch: the
        rows of ``draws["plan"][i]`` (``sghmc.first_epoch_draws``) of the
        train split, prepared as the step sees them."""
        raise NotImplementedError

    def loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The training loss of ``logits`` against ``target``."""
        raise NotImplementedError
