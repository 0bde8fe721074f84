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

An ensemble made by a sampler on a device mesh (``parallel.Mesh``) keeps
the mesh. When its chains are sharded over the mesh's 'chain' axis
(``sharded``), ``state`` holds this rank's members only: the chains of its
block, draw-major, as the JAX package orders them; ``num_members`` counts
the members of every rank, and ``gather()`` returns the whole ensemble on
every rank. When the sampler replicated its chains over the chain axis
(``replicated``: the axis does not divide them), every rank holds every
member and nothing is summed over 'chain'. The tasks evaluate it where it
lies (``tasks.base.accumulate_split``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..models.common import dropout_generator
from ..util import StateDict, index_state_dict, make_generator, stack_state_dicts


@dataclass
class Ensemble:
    module: nn.Module
    state: StateDict  # each entry (S, ...): this rank's members
    num_members: int  # over every rank
    dropout_seed: Optional[int] = None
    mesh: Any = None  # the parallel.Mesh the members were made on, or None
    chains: int = 1  # members a draw, over every rank
    replicated: bool = False  # every chain rank holds every chain

    @property
    def sharded(self) -> bool:
        """Whether the members are split over the mesh's chain ranks."""
        return (self.mesh is not None and self.mesh.shape["chain"] > 1 and self.chains > 1
                and not self.replicated)

    @property
    def local_members(self) -> int:
        return next(iter(self.state.values())).shape[0]

    def gather(self) -> "Ensemble":
        """The whole ensemble, draw-major, on every rank, without a mesh
        (a collective over the chain ranks when ``sharded``: every rank
        calls it)."""
        if self.mesh is None:
            return self
        state = self.state
        if self.sharded:  # (S, local) blocks into zero-filled (S, chains), summed over 'chain'
            cs, c = self.mesh.shape["chain"], self.mesh.chain_idx
            local = self.chains // cs
            state = {}
            for k, v in self.state.items():
                blocks = v.reshape((-1, local) + tuple(v.shape[1:]))
                state[k] = blocks.new_zeros((blocks.shape[0], self.chains) + tuple(v.shape[1:]))
                state[k][:, c * local:(c + 1) * local] = blocks
            self.mesh.all_reduce_many(list(state.values()), "chain")
            state = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in state.items()}
        return Ensemble(self.module, state, self.num_members, self.dropout_seed)

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
        """(S, B, C) eval-mode logits of every member held here for an
        NCHW batch, the ``batch_idx``-th of its pass."""
        was_training = self.module.training
        self.module.eval()
        out = []
        try:
            for i in range(self.local_members):
                gen = (None if self.dropout_seed is None
                       else make_generator(x.device, self.dropout_seed, i, batch_idx))
                with dropout_generator(self.module, gen):
                    out.append(functional_call(self.module, self.member(i), (x,)))
        finally:
            self.module.train(was_training)
        return torch.stack(out)
