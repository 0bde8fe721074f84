"""Uncertainty-evaluation metrics as torch reductions.

Counterpart of ``ursabench_tpu/ops/metrics.py``, formula for formula:
- ECE over 15 bins with (lower, upper] semantics;
- AUROC as the Mann-Whitney rank statistic with tie-averaged ranks
  (== sklearn.roc_auc_score);
- AUCPR as sklearn's step sum, the precision at each positive's tie-group
  end (== sklearn.average_precision_score).
Degenerate label sets give NaN where sklearn raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def error_rate(mean_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    acc = (torch.argmax(mean_probs, dim=1) == targets).to(mean_probs.dtype).mean()
    return 1.0 - acc


def nll(mean_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """F.nll_loss(log(probs), targets): mean negative log prob of the target."""
    logp = torch.log(mean_probs)
    return -torch.gather(logp, 1, targets[:, None])[:, 0].mean()


def brier_score(mean_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    one_hot = F.one_hot(targets, mean_probs.shape[1]).to(mean_probs.dtype)
    return torch.mean(torch.sum((mean_probs - one_hot) ** 2, dim=1))


def ece(mean_probs: torch.Tensor, targets: torch.Tensor, n_bins: int = 15) -> torch.Tensor:
    """Expected calibration error, bin b = (b/n, (b+1)/n]."""
    confidences, _ = torch.max(mean_probs, dim=1)
    accuracies = (torch.argmax(mean_probs, dim=1) == targets).to(mean_probs.dtype)
    bins = torch.clamp(torch.ceil(confidences * n_bins).to(torch.int64) - 1, 0, n_bins - 1)
    n = confidences.shape[0]
    zeros = torch.zeros(n_bins, dtype=mean_probs.dtype, device=mean_probs.device)
    counts = zeros.index_add(0, bins, torch.ones_like(confidences))
    acc_sum = zeros.index_add(0, bins, accuracies)
    conf_sum = zeros.index_add(0, bins, confidences)
    safe = torch.clamp(counts, min=1.0)
    delta = torch.abs(conf_sum / safe - acc_sum / safe)
    return torch.sum(torch.where(counts > 0, delta * counts / n, zeros))


def _tie_averaged_ranks(scores: torch.Tensor) -> torch.Tensor:
    """1-based ranks, ties given their group's average rank."""
    s, _ = torch.sort(scores)
    lo = torch.searchsorted(s, scores, side="left")
    hi = torch.searchsorted(s, scores, side="right")
    return (lo + hi + 1).to(scores.dtype) / 2.0


def auroc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """roc_auc_score(labels, scores); labels in {0,1}, higher score => 1."""
    labels = labels.to(scores.dtype)
    ranks = _tie_averaged_ranks(scores)
    npos = torch.sum(labels)
    nneg = labels.shape[0] - npos
    pos_rank_sum = torch.sum(ranks * labels)
    return (pos_rank_sum - npos * (npos + 1) / 2.0) / (npos * nneg)


def average_precision(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """average_precision_score(labels, scores): (1/npos) times the sum over
    positives of the precision at their tie-group end."""
    labels = labels.to(scores.dtype)
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    s_desc = scores[order]
    y_desc = labels[order]
    tp_cum = torch.cumsum(y_desc, dim=0)
    asc = torch.flip(s_desc, dims=(0,))
    # number of samples scoring >= v: the tie group's end index + 1
    ge1 = n - torch.searchsorted(asc, s_desc, side="left")
    prec_at_group_end = tp_cum[ge1 - 1] / ge1.to(scores.dtype)
    npos = torch.sum(labels)
    return torch.sum(y_desc * prec_at_group_end) / npos


def misclass_targets(mean_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 where the top-1 prediction is wrong."""
    return (torch.argmax(mean_probs, dim=1) != targets).to(mean_probs.dtype)


def misclass_criterion(preds: torch.Tensor, criterion: str,
                       expected_data_uncertainty: torch.Tensor | None = None
                       ) -> torch.Tensor:
    if criterion == "entropy":
        return torch.sum(-preds * torch.log(preds), dim=1)
    if criterion == "confidence":
        return -torch.max(preds, dim=1).values
    if criterion == "model_uncertainty":
        total = torch.sum(-preds * torch.log(preds), dim=1)
        return total - expected_data_uncertainty
    raise NotImplementedError(criterion)


def misclass_auroc(preds, targets, criterion, expected_data_uncertainty=None):
    m = misclass_targets(preds, targets)
    v = misclass_criterion(preds, criterion, expected_data_uncertainty)
    return auroc(m, v)


def misclass_aucpr(preds, targets, criterion, expected_data_uncertainty=None):
    m = misclass_targets(preds, targets)
    v = misclass_criterion(preds, criterion, expected_data_uncertainty)
    return average_precision(m, v)
