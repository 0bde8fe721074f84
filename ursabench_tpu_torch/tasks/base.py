"""Task protocol (``reset`` / ``update_statistics(ensemble,
output_performance)`` / ``get_performance_metrics``) and the BMA pass.

Counterpart of ``ursabench_tpu/tasks/base.py:17-128``.
"""

from __future__ import annotations

import time

import torch

from ..data.transforms import normalize
from ..inference.ensemble import Ensemble
from ..util import central_smoothing, predictive_entropy, softmax_probs


class _Task:
    def __init__(self, data_loader=None, num_classes=None, device=None):
        self.data_loader = data_loader
        self.num_classes = num_classes
        self.device = device  # accepted for parity; the ensemble's device is used

    def reset(self):
        raise NotImplementedError

    def update_statistics(self, models, output_performance=False):
        raise NotImplementedError

    def get_performance_metrics(self):
        raise NotImplementedError


@torch.no_grad()
def accumulate_split(ensemble: Ensemble, split, smooth_probs: bool):
    """One pass over ``split`` on the ensemble's device, every member on
    every batch. Returns numpy ``(sum over members of probs, sum over
    members of the entropy of the smoothed probs)``; with ``smooth_probs``
    the summed probabilities are the centrally smoothed ones.

    Batches keep the split's batch size: the last one is filled up with
    index 0 and the padded rows are sliced off at the end. Batch ``bi`` is
    passed to ``logits_all``, which keys the members' dropout streams.

    Adds the pass's seconds (to the host copy of its sums) to
    ``accumulate_split.seconds`` and its images to ``.images``."""
    t0 = time.perf_counter()
    device = ensemble.device
    images, _ = split.device_tensors(device)
    n, bsz = split.n, split.batch_size
    nb = -(-n // bsz)
    pad = nb * bsz - n
    idx = torch.arange(n, device=device)
    if pad:
        idx = torch.cat([idx, torch.zeros(pad, dtype=idx.dtype, device=device)])
    idx = idx.view(nb, bsz)
    acc_p = acc_e = None
    for bi in range(nb):
        x = normalize(images.index_select(0, idx[bi]), split.spec)
        logits = ensemble.logits_all(x.permute(0, 3, 1, 2).contiguous(), bi)
        probs = softmax_probs(logits.to(torch.float32))
        smoothed = central_smoothing(probs)
        if acc_p is None:
            acc_p = torch.zeros(nb * bsz, probs.shape[-1], device=device)
            acc_e = torch.zeros(nb * bsz, device=device)
        rows = slice(bi * bsz, (bi + 1) * bsz)
        acc_p[rows] = torch.sum(smoothed if smooth_probs else probs, dim=0)
        acc_e[rows] = torch.sum(predictive_entropy(smoothed), dim=0)
    out = acc_p[:n].cpu().numpy(), acc_e[:n].cpu().numpy()
    accumulate_split.seconds += time.perf_counter() - t0
    accumulate_split.images += n
    return out


accumulate_split.seconds = 0.0  # BMA passes' seconds since the last reset
accumulate_split.images = 0  # and their images
