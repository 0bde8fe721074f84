"""Posterior ensembles as one module plus stacked state dicts.

Counterpart of ``ursabench_tpu/inference/ensemble.py``: every entry of
``state`` (parameters and BatchNorm buffers) carries a leading sample axis
S. Members run one after another through ``torch.func.functional_call`` on
the one module.

An MCdropout ensemble shares one set of weights (``expand``ed views, not S
copies) and gives each member its own dropout stream: with ``dropout_seed``
set, member i on batch ``batch_idx`` draws its masks from a generator
seeded with (dropout_seed, i, batch_idx), the counterpart of the JAX
package's ``fold_in(key_i, batch_idx)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..models.common import dropout_generator
from ..util import StateDict, index_state_dict, make_generator, stack_state_dicts


@dataclass
class Ensemble:
    module: nn.Module
    state: StateDict  # each entry (S, ...)
    num_members: int
    dropout_seed: Optional[int] = None

    @staticmethod
    def from_list(module: nn.Module, states: Sequence[StateDict]) -> "Ensemble":
        return Ensemble(module, stack_state_dicts(states), len(states))

    @property
    def device(self) -> torch.device:
        return next(iter(self.state.values())).device

    def member(self, i: int) -> StateDict:
        return index_state_dict(self.state, i)

    @torch.no_grad()
    def logits_all(self, x: torch.Tensor, batch_idx: int = 0) -> torch.Tensor:
        """(S, B, C) eval-mode logits of every member for an NCHW batch,
        the ``batch_idx``-th of its pass."""
        was_training = self.module.training
        self.module.eval()
        out = []
        try:
            for i in range(self.num_members):
                gen = (None if self.dropout_seed is None
                       else make_generator(x.device, self.dropout_seed, i, batch_idx))
                with dropout_generator(self.module, gen):
                    out.append(functional_call(self.module, self.member(i), (x,)))
        finally:
            self.module.train(was_training)
        return torch.stack(out)
