"""Task protocol (``reset`` / ``update_statistics(ensemble,
output_performance)`` / ``get_performance_metrics``) and the BMA pass.

Counterpart of ``ursabench_tpu/tasks/base.py:17-128``.
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..data.transforms import normalize
from ..inference.engine import _Captured
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


class _PassProgram(_Captured):
    """The BMA pass of one ensemble over one split as one program (the JAX
    package's jitted scan of ``accumulate_split``), built by
    ``bma_program`` and kept by the ensemble with the split and the split's
    images on the device.

    Static buffers: the (num_batches, rows) index plan (``arange(n)`` in
    batches of the split's size, the last filled up with index 0; on a mesh
    this rank's rows of each batch), the rows of the accumulator each batch
    writes, a device batch counter, and the (num_batches * batch, C + 1)
    float64 accumulator: each row's summed probabilities, then its summed
    entropy. The members' softmax, smoothing and entropies are float32, as
    in the JAX package; their sums are float64, where the order a mesh adds
    them in moves only bits far below float32's: a pass sharded over a mesh
    returns one process's float32 sums.
    The step gathers the counter's row and normalizes, permutes to NCHW,
    runs the members' logits in the layout ``Ensemble.strategy`` picks
    (``Ensemble.member_logits``), takes the float32 softmax and its central
    smoothing, writes the sums over the members into the counter's rows
    (``index_copy_``) and advances the counter. A call zeroes the counter
    and the accumulator, runs the step once a batch (``_Captured``: on the
    card replays of one capture), all-reduces the accumulator on a mesh
    (outside the graph) and copies it to the host once. A dropout
    ensemble's masks for batch ``bi`` are drawn into static buffers before
    its step (``Ensemble.draw_masks``). The members' state is read where it
    lies, so the program serves until a state tensor of the ensemble is a
    new object."""

    def __init__(self, ensemble: Ensemble, split, smooth_probs: bool):
        device = ensemble.device
        # the ensemble holds its programs: a weak reference back, so that a
        # dropped ensemble frees its graphs at once, never in a garbage
        # collection that may run inside another program's capture
        ref = weakref.ref(ensemble)
        super().__init__(device, lambda: ref().graph_pool())
        self.ensemble = weakref.proxy(ensemble)
        self.split, self.smooth_probs = split, bool(smooth_probs)
        self.state = dict(ensemble.state)  # the tensors it reads
        self.images, _ = split.device_tensors(device)
        n, bsz = split.n, split.batch_size
        mesh = ensemble.mesh
        # members with dropout streams draw masks for the whole batch: each
        # data rank evaluates it all
        self.split_rows = mesh is not None and ensemble.dropout_seed is None
        mine = mesh.data_rows(bsz) if self.split_rows else slice(0, bsz)  # this rank's rows
        nb = -(-n // bsz)
        idx = torch.arange(nb * bsz, device=device)
        self.plan = torch.where(idx < n, idx, 0).view(nb, bsz)[:, mine].contiguous()
        self.dest = idx.view(nb, bsz)[:, mine].contiguous()
        self.images_padded = nb * bsz
        self.batch = torch.zeros((), dtype=torch.int64, device=device)
        h, w, c = split.spec.shape
        rows = self.plan.shape[1]
        self.strategy = ensemble.strategy(bsz, (c, h, w))
        self.calls = ensemble.dropout_calls(torch.zeros((rows, c, h, w), device=device))
        self.layers = [layer for layer, _ in self.calls]
        self.masks = [torch.zeros((ensemble.local_members,) + tuple(shape), dtype=torch.bool,
                                  device=device) for _, shape in self.calls]
        self.acc: Optional[torch.Tensor] = None  # made by the first step, an eager one

    def current(self, ensemble: Ensemble, split) -> bool:
        """Whether the program still serves ``ensemble`` on ``split``."""
        state = ensemble.state
        h, w, c = split.spec.shape
        return (self.split is split and state.keys() == self.state.keys()
                and all(state[k] is v for k, v in self.state.items())
                and self.strategy == ensemble.strategy(split.batch_size, (c, h, w)))

    @torch.no_grad()
    def __call__(self, eager: bool = False):
        """Numpy ``(summed probabilities (n, C), summed entropies (n,))``
        (``eager``: every step on the current stream, uncaptured)."""
        self.batch.zero_()
        if self.acc is not None:
            self.acc.zero_()
        for bi in range(self.plan.shape[0]):
            if self.calls:
                self.ensemble.draw_masks(self.calls, bi, out=self.masks)
            self._advance(eager)
        ens, mesh = self.ensemble, self.ensemble.mesh
        axis = {(True, True): "all", (True, False): "chain", (False, True): "data"}.get(
            (ens.sharded, self.split_rows and mesh.shape["data"] > 1))
        if axis is not None:
            mesh.all_reduce(self.acc, axis)
        out = self.acc[:self.split.n].to(torch.float32).cpu().numpy()
        return np.ascontiguousarray(out[:, :-1]), np.ascontiguousarray(out[:, -1])

    def _step(self) -> None:
        i = self.batch.view(1)
        x = normalize(self.images.index_select(0, self.plan.index_select(0, i).squeeze(0)),
                      self.split.spec)
        logits = self.ensemble.member_logits(x.permute(0, 3, 1, 2).contiguous(), self.strategy,
                                             self.layers, self.masks)
        probs = softmax_probs(logits.to(torch.float32))
        smoothed = central_smoothing(probs)
        f64 = torch.float64  # sums whose order leaves their float32 rounding as it is
        sums = torch.cat([torch.sum((smoothed if self.smooth_probs else probs).to(f64), dim=0),
                          torch.sum(predictive_entropy(smoothed).to(f64), dim=0)[:, None]],
                         dim=1)
        if self.acc is None:
            self.acc = sums.new_zeros((self.images_padded, sums.shape[1]))
        self.acc.index_copy_(0, self.dest.index_select(0, i).squeeze(0), sums)
        self.batch.add_(1)


def bma_program(ensemble: Ensemble, split, smooth_probs: bool) -> _PassProgram:
    """The ensemble's pass program over ``split`` (``accumulate_split``'s),
    built on first use and kept by the ensemble: again only when a state
    tensor of the ensemble is a new object or its member layout changed."""
    key = ("accumulate", id(split), bool(smooth_probs))
    prog = ensemble._programs.get(key)
    if prog is None or not prog.current(ensemble, split):
        prog = ensemble._programs[key] = _PassProgram(ensemble, split, smooth_probs)
    return prog


@torch.no_grad()
def accumulate_split(ensemble: Ensemble, split, smooth_probs: bool):
    """One pass over ``split`` on the ensemble's device, every member on
    every batch. Returns numpy ``(sum over members of probs, sum over
    members of the entropy of the smoothed probs)``; with ``smooth_probs``
    the summed probabilities are the centrally smoothed ones.

    It runs the ensemble's program for the split (``bma_program``,
    ``_PassProgram``): on the card a step captured once as a CUDA graph and
    replayed a batch at a time, on the CPU the same step run eagerly.
    Batches keep the split's batch size: the last one is filled up with
    index 0 and the padded rows are sliced off at the end. Member i's
    dropout masks on batch ``bi`` come from (dropout_seed, i, bi).

    An ensemble made on a device mesh is evaluated where it lies, as the
    JAX package's ``shard_ensemble_eval`` lays it out: each rank sums its
    own members on its rows of every batch (the batch split over 'data';
    not for members with dropout streams, whose masks are drawn for the
    whole batch: each data rank evaluates it all), and one all-reduce of
    the zero-filled sums, over the chain ranks where the members are
    sharded and over the data ranks where the rows are, gives each rank
    the sums of the whole ensemble (``ensemble.gather()``'s, up to the
    order of the sum).

    Counted in ``tracing``'s ``bma.pass``: the pass's seconds (to the host
    copy of its sums), its images and one pass on the program's path
    (``"graph"`` or ``"eager"``)."""
    with tracing.span("bma.pass"):
        t0 = time.perf_counter()
        prog = bma_program(ensemble, split, smooth_probs)
        out = prog()
        tracing.bma_pass(time.perf_counter() - t0, split.n, prog.path)
    return out
