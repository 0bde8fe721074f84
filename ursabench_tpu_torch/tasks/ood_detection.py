"""OOD detection task: total- and model-uncertainty AUROC.

Counterpart of ``ursabench_tpu/tasks/ood_detection.py``. The in and out
splits each get one BMA pass that accumulates the *smoothed* probabilities
and the entropy of the smoothed per-member probabilities; OOD points are
labelled 1. The entropies and the AUROC are computed in float32 from the
float64 sums, as the JAX package computes them (``jnp.asarray`` of float64
numpy with x64 off): the same rounding keeps the same ties.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference.ensemble import Ensemble
from ..ops import metrics as M
from ..util import predictive_entropy
from .base import _Task, accumulate_split

__all__ = ["OODDetection", "ood_aurocs"]


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def ood_aurocs(in_proba, out_proba, in_data_unc, out_data_unc, n) -> dict:
    """The two AUROCs from the accumulators summed over ``n`` samples."""
    in_total = predictive_entropy(_f32(in_proba / n))
    out_total = predictive_entropy(_f32(out_proba / n))
    in_model = in_total - _f32(in_data_unc / n)
    out_model = out_total - _f32(out_data_unc / n)
    labels = torch.cat([torch.ones(len(out_total)), torch.zeros(len(in_total))])
    return {
        "total_uncertainty_auroc": float(M.auroc(labels, torch.cat([out_total, in_total]))),
        "model_uncertainty_auroc": float(M.auroc(labels, torch.cat([out_model, in_model]))),
    }


class OODDetection(_Task):
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

    def update_statistics(self, models: Ensemble, output_performance=True):
        self.num_samples_collected += models.num_members
        p_in, e_in = accumulate_split(models, self.in_split, smooth_probs=True)
        p_out, e_out = accumulate_split(models, self.out_split, smooth_probs=True)
        self.in_proba += p_in
        self.out_proba += p_out
        self.in_data_unc += e_in
        self.out_data_unc += e_out
        if output_performance:
            return self.get_performance_metrics()

    def get_performance_metrics(self):
        return ood_aurocs(self.in_proba, self.out_proba, self.in_data_unc,
                          self.out_data_unc, self.num_samples_collected)
