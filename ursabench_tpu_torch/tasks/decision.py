"""Cost-sensitive Bayes decision task.

Counterpart of ``ursabench_tpu/tasks/decision.py``: a cost matrix per
dataset (MNIST: missing a 3 or a 7 costs 100; CIFAR-10: the vehicles
plane, automobile, ship and truck cost 1; CIFAR-100: the fine labels
pickup_truck 58, rocket 69 and tank 85 cost 1; every other mistake 0.1),
the risk ``p @ C`` accumulated on the smoothed probabilities, in float64
numpy on the host, the decision its argmin, and the realized cost
``C[y, D].sum()``.
"""

from __future__ import annotations

import numpy as np

from ..inference.ensemble import Ensemble
from .base import _Task, accumulate_split

__all__ = ["Decision", "decision_cost", "mnist_cost", "cifar10_cost", "cifar100_cost"]


def _cost_matrix(num_classes: int, important_rows) -> np.ndarray:
    c = np.full((num_classes, num_classes), 0.1)
    c[list(important_rows), :] = 1.0
    np.fill_diagonal(c, 0.0)
    return c


def mnist_cost(num_classes: int = 10) -> np.ndarray:
    c = np.full((num_classes, num_classes), 0.1)
    c[[3, 7], :] = 100.0
    np.fill_diagonal(c, 0.0)
    return c


def cifar10_cost(num_classes: int = 10) -> np.ndarray:
    return _cost_matrix(num_classes, [0, 1, 8, 9])


def cifar100_cost(num_classes: int = 100) -> np.ndarray:
    return _cost_matrix(num_classes, [58, 69, 85])


_COST_BY_DATASET = {
    "MNIST": mnist_cost,
    "CIFAR10": cifar10_cost,
    "CIFAR100": cifar100_cost,
}


def decision_cost(decisions: np.ndarray, y_true: np.ndarray, cost_mat: np.ndarray):
    return float(cost_mat[y_true, decisions].sum())


class Decision(_Task):
    def __init__(self, dataloader, num_classes, device=None, cost_mat=None):
        super().__init__(dataloader, num_classes, device)
        self.split = dataloader["decision_data_test"]
        self.num_classes = num_classes
        name = self.split.dataset_name
        if cost_mat is not None:
            self.cost_mat = np.asarray(cost_mat)
        elif name in _COST_BY_DATASET:
            self.cost_mat = _COST_BY_DATASET[name](num_classes)
        else:
            raise NotImplementedError(f"No cost matrix for dataset {name!r}")
        self.targets = np.asarray(self.split.labels)
        self.reset()

    def reset(self):
        self.num_samples_collected = 0
        self.ensemble_proba = np.zeros((self.split.n, self.num_classes))
        self.risk = np.zeros((self.split.n, self.num_classes))

    def update_statistics(self, models: Ensemble, output_performance=True, smoothing=True):
        self.num_samples_collected += models.num_members
        probs, _ = accumulate_split(models, self.split, smooth_probs=True)
        self.ensemble_proba += probs
        self.risk += probs @ self.cost_mat
        if output_performance:
            return self.get_performance_metrics(output_performance, smoothing)

    def get_performance_metrics(self, output_performance=False, smoothing=True):
        mean_risk = self.risk / self.num_samples_collected
        decisions = np.argmin(mean_risk, axis=1)
        return {
            "True_Cost": decision_cost(decisions, self.targets, self.cost_mat),
            "Decision": decisions,
            "Pred_cost": self.risk,
        }
