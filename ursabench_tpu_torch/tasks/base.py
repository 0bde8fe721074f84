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

    An ensemble made on a device mesh is evaluated where it lies, as the
    JAX package's ``shard_ensemble_eval`` lays it out: each rank sums its
    own members on its rows of every batch (the batch split over 'data';
    not for members with dropout streams, whose masks are drawn for the
    whole batch: each data rank evaluates it all), and one all-reduce of
    the zero-filled sums, over the chain ranks where the members are
    sharded and over the data ranks where the rows are, gives each rank
    the sums of the whole ensemble (``ensemble.gather()``'s, up to the
    order of the sum).

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
    mesh = ensemble.mesh
    split_rows = mesh is not None and ensemble.dropout_seed is None
    mine = mesh.data_rows(bsz) if split_rows else slice(0, bsz)  # this rank's rows
    acc_p = acc_e = None
    for bi in range(nb):
        x = normalize(images.index_select(0, idx[bi, mine]), split.spec)
        logits = ensemble.logits_all(x.permute(0, 3, 1, 2).contiguous(), bi)
        probs = softmax_probs(logits.to(torch.float32))
        smoothed = central_smoothing(probs)
        if acc_p is None:
            acc_p = torch.zeros(nb * bsz, probs.shape[-1], device=device)
            acc_e = torch.zeros(nb * bsz, device=device)
        rows = slice(bi * bsz + mine.start, bi * bsz + mine.stop)
        acc_p[rows] = torch.sum(smoothed if smooth_probs else probs, dim=0)
        acc_e[rows] = torch.sum(predictive_entropy(smoothed), dim=0)
    axis = {(True, True): "all", (True, False): "chain", (False, True): "data"}.get(
        (ensemble.sharded, split_rows and mesh.shape["data"] > 1))
    if axis is not None:
        mesh.all_reduce_many([acc_p, acc_e], axis)
    out = acc_p[:n].cpu().numpy(), acc_e[:n].cpu().numpy()
    accumulate_split.seconds += time.perf_counter() - t0
    accumulate_split.images += n
    return out


accumulate_split.seconds = 0.0  # BMA passes' seconds since the last reset
accumulate_split.images = 0  # and their images
