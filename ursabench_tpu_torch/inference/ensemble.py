"""Posterior ensembles as one module plus stacked state dicts.

Counterpart of ``ursabench_tpu/inference/ensemble.py``: every entry of
``state`` (parameters and BatchNorm buffers) carries a leading sample axis
S. Members run one after another through ``torch.func.functional_call`` on
the one module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..util import StateDict, index_state_dict, stack_state_dicts


@dataclass
class Ensemble:
    module: nn.Module
    state: StateDict  # each entry (S, ...)
    num_members: int

    @staticmethod
    def from_list(module: nn.Module, states: Sequence[StateDict]) -> "Ensemble":
        return Ensemble(module, stack_state_dicts(states), len(states))

    @property
    def device(self) -> torch.device:
        return next(iter(self.state.values())).device

    def member(self, i: int) -> StateDict:
        return index_state_dict(self.state, i)

    @torch.no_grad()
    def logits_all(self, x: torch.Tensor) -> torch.Tensor:
        """(S, B, C) eval-mode logits of every member for an NCHW batch."""
        was_training = self.module.training
        self.module.eval()
        try:
            return torch.stack([
                functional_call(self.module, self.member(i), (x,))
                for i in range(self.num_members)
            ])
        finally:
            self.module.train(was_training)
