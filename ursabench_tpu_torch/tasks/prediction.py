"""Prediction task: the BMA metric suite.

Counterpart of ``ursabench_tpu/tasks/prediction.py``: the 11 metrics
(error_rate, nll, ll, brier_score, ece and six misclassification
AUROC/AUCPR) with central smoothing where the reference applies it: the
accumulated probabilities are not smoothed, the entropy input and the
nll / misclassification inputs are. Metrics are computed in float32 on
the host, as the JAX package computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference.ensemble import Ensemble
from ..ops import metrics as M
from ..util import central_smoothing
from .base import _Task, accumulate_split

__all__ = ["Prediction"]


class Prediction(_Task):
    supported_metric_list = [
        "error_rate", "nll", "ll", "brier_score", "ece",
        "misclass_model_uncertainty_auroc", "misclass_model_uncertainty_aucpr",
        "misclass_total_uncertainty_auroc", "misclass_total_uncertainty_aucpr",
        "misclass_confidence_auroc", "misclass_confidence_aucpr",
    ]

    def __init__(self, dataloader, num_classes, device=None, metric_list="ALL"):
        super().__init__(dataloader, num_classes, device)
        self.split = dataloader["in_distribution_test"]
        self.num_classes = num_classes
        self.required_metric_list = (
            self.supported_metric_list if metric_list == "ALL" else metric_list
        )
        unknown = [m for m in self.required_metric_list
                   if m not in self.supported_metric_list]
        if unknown:
            raise ValueError(f"unsupported metrics {unknown}")
        self.targets = np.asarray(self.split.labels)
        self.reset()

    def reset(self):
        self.num_samples_collected = 0
        self.ensemble_proba = np.zeros((self.split.n, self.num_classes))
        self.expected_data_uncertainty = np.zeros(self.split.n)

    def update_statistics(self, models: Ensemble, output_performance=True, smoothing=True):
        self.num_samples_collected += models.num_members
        probs, ent = accumulate_split(models, self.split, smooth_probs=False)
        self.ensemble_proba += probs
        self.expected_data_uncertainty += ent
        if output_performance:
            return self.get_performance_metrics(output_performance, smoothing)

    def get_performance_metrics(self, output_performance=False, smoothing=True):
        f32 = torch.float32
        mean_probs = torch.as_tensor(
            self.ensemble_proba / self.num_samples_collected, dtype=f32)
        smoothed = central_smoothing(mean_probs)
        targets = torch.as_tensor(self.targets)
        edu = torch.as_tensor(
            self.expected_data_uncertainty / self.num_samples_collected, dtype=f32)
        out = {}
        for metric in self.required_metric_list:
            if metric == "error_rate":
                out[metric] = float(M.error_rate(mean_probs, targets))
            elif metric in ("nll", "ll"):
                p = smoothed if smoothing else mean_probs
                v = float(M.nll(p, targets))
                out[metric] = -v if metric == "ll" else v
            elif metric == "brier_score":
                out[metric] = float(M.brier_score(mean_probs, targets))
            elif metric == "ece":
                out[metric] = float(M.ece(mean_probs, targets))
            else:
                crit = ("model_uncertainty" if "model_uncertainty" in metric
                        else "entropy" if "total_uncertainty" in metric
                        else "confidence")
                fn = M.misclass_auroc if metric.endswith("auroc") else M.misclass_aucpr
                out[metric] = float(fn(smoothed, targets, crit, edu))
        if output_performance:
            if len(self.required_metric_list) != 1:
                raise RuntimeError(
                    "Multiple metrics in metric list not suitable for "
                    "output_performance = True"
                )
            return float(out[self.required_metric_list[0]])
        return out
