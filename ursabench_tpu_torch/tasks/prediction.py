"""Prediction task: the BMA metric suite.

Counterpart of ``ursabench_tpu/tasks/prediction.py``: the 11 metrics
(error_rate, nll, ll, brier_score, ece and six misclassification
AUROC/AUCPR) with central smoothing where the reference applies it: the
accumulated probabilities are not smoothed, the entropy input and the
nll / misclassification inputs are. Metrics are computed in float32 on
the host, as the JAX package computes them.

``latency_mode=True`` takes the batches one by one, in order, the last one
short, and records each batch's wall time in ``latencies``: the ensemble's
forward plus the device->host copy of its logits (the batch is normalized
before the clock starts). It is the API that trtprof's run_prediction.py
expects of the task.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..inference.ensemble import Ensemble
from ..ops import metrics as M
from ..util import central_smoothing, predictive_entropy, softmax_probs
from .base import _Task, accumulate_split

__all__ = ["Prediction"]


class Prediction(_Task):
    supported_metric_list = [
        "error_rate", "nll", "ll", "brier_score", "ece",
        "misclass_model_uncertainty_auroc", "misclass_model_uncertainty_aucpr",
        "misclass_total_uncertainty_auroc", "misclass_total_uncertainty_aucpr",
        "misclass_confidence_auroc", "misclass_confidence_aucpr",
    ]

    def __init__(self, dataloader, num_classes, device=None, metric_list="ALL",
                 latency_mode=False):
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
        self.latency_mode = latency_mode
        self.latencies: list = []
        self.reset()

    def reset(self):
        self.num_samples_collected = 0
        self.ensemble_proba = np.zeros((self.split.n, self.num_classes))
        self.expected_data_uncertainty = np.zeros(self.split.n)

    def update_statistics(self, models: Ensemble, output_performance=True, smoothing=True):
        self.num_samples_collected += models.num_members
        if self.latency_mode:
            probs, ent = self._accumulate_timed(models)
        else:
            probs, ent = accumulate_split(models, self.split, smooth_probs=False)
        self.ensemble_proba += probs
        self.expected_data_uncertainty += ent
        if output_performance:
            return self.get_performance_metrics(output_performance, smoothing)

    @torch.no_grad()
    def _accumulate_timed(self, models: Ensemble):
        models = models.gather()  # every member on every rank: one latency a batch
        probs_chunks, ent_chunks = [], []
        for bi, (x, _) in enumerate(self.split.batches(models.device)):
            x = x.permute(0, 3, 1, 2).contiguous()
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            logits = models.logits_all(x, bi)
            logits.cpu()  # the timed device->host copy; the logits stay on the device
            self.latencies.append(time.perf_counter() - t0)
            p = softmax_probs(logits.to(torch.float32))
            probs_chunks.append(torch.sum(p, dim=0).cpu().numpy())
            ent_chunks.append(torch.sum(predictive_entropy(central_smoothing(p)),
                                        dim=0).cpu().numpy())
        return np.concatenate(probs_chunks), np.concatenate(ent_chunks)

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
