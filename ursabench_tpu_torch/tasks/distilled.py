"""Distilled-posterior tasks.

Counterpart of ``ursabench_tpu/tasks/distilled.py``. The "ensemble" is a
pair of deterministic models: the first predicts the BMA class
probabilities, the second the log of the expected data entropy (read out
through ``exp``). Batches come from ``split.batches`` in order, on the
device of the pair's state, and each statistics pass counts as one sample.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..util import StateDict, central_smoothing, predictive_entropy, softmax_probs
from .base import _Task
from .ood_detection import ood_aurocs
from .prediction import Prediction

__all__ = ["DistilledPair", "PredictionDistilled", "OODDetectionDistilled"]


@dataclass
class DistilledPair:
    """(prediction model, expected-data-uncertainty model), each a module
    with its state dict; both run in eval mode on their state's device."""

    pred_module: nn.Module
    pred_state: StateDict
    unc_module: nn.Module
    unc_state: StateDict

    @property
    def device(self) -> torch.device:
        return next(iter(self.pred_state.values())).device

    @staticmethod
    @torch.no_grad()
    def _apply(module: nn.Module, state: StateDict, x: torch.Tensor) -> torch.Tensor:
        was_training = module.training
        module.eval()
        try:
            return functional_call(module, state, (x,))
        finally:
            module.train(was_training)

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """Class probabilities for an NCHW batch."""
        return softmax_probs(self._apply(self.pred_module, self.pred_state, x).float())

    def entropy(self, x: torch.Tensor) -> torch.Tensor:
        """The expected data entropy for an NCHW batch: ``exp`` of the
        second model's output."""
        return torch.exp(self._apply(self.unc_module, self.unc_state, x).float()).reshape(-1)


def _accumulate_pair(pair: DistilledPair, split, smooth_probs: bool):
    probs_chunks, ent_chunks = [], []
    for x, _ in split.batches(pair.device):
        x = x.permute(0, 3, 1, 2).contiguous()
        p = pair.probs(x)
        if smooth_probs:
            p = central_smoothing(p)
        probs_chunks.append(p.cpu().numpy())
        ent_chunks.append(pair.entropy(x).cpu().numpy())
    return np.concatenate(probs_chunks), np.concatenate(ent_chunks)


class PredictionDistilled(Prediction):
    """Prediction's metrics; one statistics pass counts as one sample, and
    the probabilities are not smoothed."""

    def update_statistics(self, models: DistilledPair, output_performance=True,
                          smoothing=True):
        if not isinstance(models, DistilledPair):
            raise TypeError("PredictionDistilled needs a DistilledPair")
        self.num_samples_collected += 1
        probs, ent = _accumulate_pair(models, self.split, smooth_probs=False)
        self.ensemble_proba += probs
        self.expected_data_uncertainty += ent
        if output_performance:
            return self.get_performance_metrics(output_performance, smoothing)


class OODDetectionDistilled(_Task):
    def __init__(self, data_loader=None, num_classes=None, device=None):
        super().__init__(data_loader, num_classes, device)
        self.in_split = data_loader["in_distribution_test"]
        self.out_split = data_loader["out_distribution_test"]
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.in_proba = np.zeros((self.in_split.n, self.num_classes))
        self.out_proba = np.zeros((self.out_split.n, self.num_classes))
        self.in_data_unc = np.zeros(self.in_split.n)
        self.out_data_unc = np.zeros(self.out_split.n)
        self.num_samples_collected = 0

    def update_statistics(self, models: DistilledPair, output_performance=True):
        if not isinstance(models, DistilledPair):
            raise TypeError("OODDetectionDistilled needs a DistilledPair")
        self.num_samples_collected += 1
        p_in, e_in = _accumulate_pair(models, self.in_split, smooth_probs=True)
        self.in_proba += p_in
        self.in_data_unc += e_in
        # on the OOD split the reference takes the entropy of the smoothed
        # probabilities, not the distilled head
        p_out, _ = _accumulate_pair(models, self.out_split, smooth_probs=True)
        self.out_proba += p_out
        self.out_data_unc += predictive_entropy(torch.from_numpy(p_out)).numpy()
        if output_performance:
            return self.get_performance_metrics()

    def get_performance_metrics(self):
        return ood_aurocs(self.in_proba, self.out_proba, self.in_data_unc,
                          self.out_data_unc, self.num_samples_collected)
