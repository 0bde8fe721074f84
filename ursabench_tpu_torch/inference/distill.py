"""Posterior distillation: compress a sampled ensemble into the
(prediction model, expected-data-uncertainty model) pair that
``PredictionDistilled`` and ``OODDetectionDistilled`` take.

Counterpart of ``ursabench_tpu/inference/distill.py``. The targets come
from one BMA pass over the train split: the first model learns the BMA
class probabilities (soft-target cross entropy), the second regresses the
log of the expected data entropy (mean squared error). Each trains with
Adam (``torch.optim.Adam`` is optax's ``adam``: eps outside the square
root). An epoch takes one permutation and drops the ragged tail; batches
are normalized without augmentation, and BatchNorm runs in train mode.
The reference draws every step's dropout from one fixed key, so here one
generator is re-seeded to the same seed before each step.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..data.arrays import DataSplit
from ..data.transforms import normalize
from ..models.common import dropout_generator, dropout_layers
from ..nn.init import torch_linear_
from ..tasks.base import accumulate_split
from ..tasks.distilled import DistilledPair
from ..util import StateDict, derive_seed, make_generator
from .base import resolve_device
from .engine import init_variables
from .ensemble import Ensemble

__all__ = ["EntropyHead", "distill_ensemble"]

_DROPOUT_SEED = 0  # the reference's fixed PRNGKey(0) at every step


class EntropyHead(nn.Module):
    """A small regression head for the uncertainty model: flatten, Dense to
    ``hidden``, tanh, Dense to 1. The output layer is registered first, as
    flax creates it in ``Dense(1)(tanh(Dense(hidden)(x)))``."""

    def __init__(self, input_dim: int, hidden: int = 32):
        super().__init__()
        self.input_dim = input_dim
        self.fc2 = nn.Linear(hidden, 1)
        self.fc1 = nn.Linear(input_dim, hidden)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for m in (self.fc1, self.fc2):
            torch_linear_(m.weight, m.bias, gen)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x.reshape(-1, self.input_dim))))


def _loss(out: torch.Tensor, t: torch.Tensor, loss_kind: str) -> torch.Tensor:
    out = out.float()
    if loss_kind == "soft_ce":
        return -torch.mean(torch.sum(t * torch.log_softmax(out, dim=-1), dim=-1))
    return torch.mean((out.reshape(t.shape) - t) ** 2)  # mse on the raw output


def _fit(module: nn.Module, split: DataSplit, targets: torch.Tensor, loss_kind: str,
         lr: float, perms: Sequence[torch.Tensor]) -> StateDict:
    """Train ``module`` (on its device, from its current weights) with Adam,
    one epoch per permutation of ``perms``: batches of ``min(batch_size,
    n)`` rows, the ragged tail dropped (never zero steps). Returns a copy of
    its state dict."""
    device = next(module.parameters()).device
    images, _ = split.device_tensors(device)
    n = split.n
    bsz = min(split.batch_size, n)
    nb = max(1, n // bsz)
    targets = targets.to(device)
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    gen = torch.Generator(device=device) if dropout_layers(module) else None
    module.train()
    for perm in perms:
        idx = perm.to(device)[: nb * bsz].view(nb, bsz)
        for b in idx:
            x = normalize(images.index_select(0, b), split.spec)
            x = x.permute(0, 3, 1, 2).contiguous()
            if gen is not None:
                gen.manual_seed(_DROPOUT_SEED)
            opt.zero_grad(set_to_none=False)
            with dropout_generator(module, gen):
                loss = _loss(module(x), targets.index_select(0, b), loss_kind)
            loss.backward()
            opt.step()
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _train_regressor(module: nn.Module, split: DataSplit, targets: torch.Tensor,
                     loss_kind: str, epochs: int, lr: float, seed: int,
                     device) -> StateDict:
    """Fresh weights from ``seed``, then ``epochs`` epochs of ``_fit``, each
    on a permutation drawn on the device from ``seed``."""
    module.to(device)
    init_variables(module, make_generator("cpu", seed, "init"))
    gen = make_generator(device, seed, "perm")
    perms = [torch.randperm(split.n, generator=gen, device=device) for _ in range(epochs)]
    return _fit(module, split, targets, loss_kind, lr, perms)


def distill_ensemble(
    ensemble: Ensemble,
    train_split: DataSplit,
    pred_module: nn.Module,
    unc_module: nn.Module,
    *,
    epochs: int = 20,
    lr: float = 1e-3,
    seed: int = 0,
    device=None,
) -> DistilledPair:
    """Distill ``ensemble`` into a DistilledPair on ``train_split``. The two
    modules are re-initialised and trained in place on ``device`` (CUDA
    when None)."""
    device = resolve_device(device)
    sum_probs, sum_ent = accumulate_split(ensemble, train_split, smooth_probs=False)
    bma_probs = torch.as_tensor(sum_probs / ensemble.num_members, dtype=torch.float32)
    expected_ent = torch.as_tensor(sum_ent / ensemble.num_members, dtype=torch.float32)
    log_ent = torch.log(torch.clamp_min(expected_ent, 1e-12))
    pred_state = _train_regressor(pred_module, train_split, bma_probs, "soft_ce",
                                  epochs, lr, derive_seed(seed, "distill", "pred"), device)
    unc_state = _train_regressor(unc_module, train_split, log_ent, "mse",
                                 epochs, lr, derive_seed(seed, "distill", "unc"), device)
    return DistilledPair(pred_module, pred_state, unc_module, unc_state)

