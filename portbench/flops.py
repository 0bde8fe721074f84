"""FLOPs of a training step and of a forward, counted from the shapes.

A copy of the method of the port's ``profiling/hw.py`` (``train_step_flops``,
``forward_flops``): ``torch.utils.flop_counter.FlopCounterMode`` over the
work on the meta device, which computes nothing and counts convolutions
and matrix products at two FLOPs a multiply-add. It counts the benchmark's
own reference models, not the program's, so a change to the program cannot
change the yardstick, and feeds each the example input and target of its
architecture (``Model.example``): images or token ids alike.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.models import Model


def _meta_tensors(model: Model, grad: bool) -> dict:
    return {leaf.name: torch.empty(leaf.shape, device="meta").requires_grad_(
        grad and not leaf.buffer) for leaf in model.leaves}


def train_step_flops(model: Model, batch: int) -> int:
    """FLOPs of one training step: the train-mode forward, the
    architecture's loss and the backward to every parameter, on a batch of
    ``batch``."""
    tensors = _meta_tensors(model, True)
    x, target = model.example(batch)
    with FlopCounterMode(display=False) as counter:
        model.loss(model.forward(tensors, x, True), target).backward()
    return int(counter.get_total_flops())


def forward_flops(model: Model, batch: int) -> int:
    """FLOPs of one eval-mode forward on a batch of ``batch``."""
    tensors = _meta_tensors(model, False)
    x, _ = model.example(batch)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward(tensors, x, False)
    return int(counter.get_total_flops())
