"""FLOPs of a training step and of a forward, counted from the shapes.

A copy of the method of the port's ``profiling/hw.py`` (``train_step_flops``,
``forward_flops``): ``torch.utils.flop_counter.FlopCounterMode`` over the
work on the meta device, which computes nothing and counts convolutions
and matrix products at two FLOPs a multiply-add. It counts the benchmark's
own reference models, not the program's, so a change to the program cannot
change the yardstick.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from .reference.models import Model


def _meta_tensors(model: Model, grad: bool) -> dict:
    return {leaf.name: torch.empty(leaf.shape, device="meta").requires_grad_(
        grad and not leaf.buffer) for leaf in model.leaves}


def train_step_flops(model: Model, batch: int) -> int:
    """FLOPs of one training step: the train-mode forward, the mean cross
    entropy and the backward to every parameter, on a batch of ``batch``."""
    h, w, c = model.image
    tensors = _meta_tensors(model, True)
    x = torch.empty((batch, c, h, w), device="meta")
    with FlopCounterMode(display=False) as counter:
        logits = model.forward(tensors, x, True)
        F.cross_entropy(logits, torch.zeros(batch, dtype=torch.long, device="meta")).backward()
    return int(counter.get_total_flops())


def forward_flops(model: Model, batch: int) -> int:
    """FLOPs of one eval-mode forward on a batch of ``batch``."""
    h, w, c = model.image
    tensors = _meta_tensors(model, False)
    x = torch.empty((batch, c, h, w), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward(tensors, x, False)
    return int(counter.get_total_flops())
