"""SGHMC and SGLD samplers.

Counterpart of ``ursabench_tpu/inference/sgmcmc.py:35-221``, which documents
the reference protocol:
- burn_in + 1 epochs before the first draw, then one epoch per draw;
- cosine annealing of the learning rate over burn_in + num_samples epochs,
  eta_min 0 at construction and lr/2 after ``update_hyp``;
- momentum = 1 - alpha, weight decay = 1/prior_std**2;
- the Langevin noise is always on (the reference's gate is vacuous);
- SGLD is SGHMC with alpha pinned to 1.

The hyperparameters live in 0-dim device tensors that ``update_hyp`` fills
in place, so changing them never rebuilds anything. cSGHMC and cSGLD are
not ported yet (ROADMAP.md open item 7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..data.transforms import draw_augment
from ..ops.sgmcmc import sghmc_update
from ..util import derive_seed, make_generator
from .base import _Inference
from .engine import (TrainState, epoch_indices, flatten_parameters,
                     init_variables, train_steps)
from .ensemble import Ensemble

_HYP_KEYS = ("lr0", "eta_min", "t_max", "momentum", "wd_over_n", "n_train")


def _cosine_hyp_lr(hyp, epoch, batch_idx, step):
    """torch CosineAnnealingLR by epoch, reading (lr0, eta_min, t_max) from
    the device tensors in ``hyp``."""
    del batch_idx, step
    return hyp["eta_min"] + (hyp["lr0"] - hyp["eta_min"]) * 0.5 * (
        1.0 + torch.cos(math.pi * float(epoch) / hyp["t_max"])
    )


def _sghmc_hyp_update(state: TrainState, hyp, *, lr, noise_on, is_first_step, seed):
    sghmc_update(
        state.params, state.momentum, state.grads, lr=lr,
        momentum=hyp["momentum"], wd_over_n=hyp["wd_over_n"],
        n_train=hyp["n_train"], noise_on=noise_on,
        is_first_step=is_first_step, seed=seed,
    )


class SGHMC(_Inference):
    _DEFAULT_HYP = {
        "lr": 0.001, "prior_std": 10, "num_samples": 2, "alpha": 0.1,
        "burn_in_epochs": 10,
    }
    _FORCE_ALPHA: Optional[float] = None  # SGLD pins this to 1.0
    _ETA_MIN_FRACTION_INIT = 0.0
    _ETA_MIN_FRACTION_UPDATE = 0.5
    _LR_FN = staticmethod(_cosine_hyp_lr)
    _UPDATE_FN = staticmethod(_sghmc_hyp_update)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None):
        super().__init__(hyperparameters, model, train, model_loss, seed,
                         chains, device)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._images, self._labels = train.device_tensors(self.device)
        params, grads = flatten_parameters(self.module)
        self._state = TrainState(self.module, params, torch.zeros_like(params), grads)
        self._hyp = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                     for k in _HYP_KEYS}
        self._noise_on = torch.ones((), dtype=torch.float32, device=self.device)
        self.epoch_losses: list = []  # mean training loss per epoch, on the device
        self._setup(hyperparameters, eta_min_fraction=self._ETA_MIN_FRACTION_INIT)

    # -- configuration ---------------------------------------------------------

    def _setup(self, hyp: dict, eta_min_fraction: float):
        self.hyperparameters = hyp
        self.lr = float(hyp["lr"])
        self.prior_std = float(hyp["prior_std"])
        self.num_samples = int(hyp["num_samples"])
        self.alpha = (
            self._FORCE_ALPHA if self._FORCE_ALPHA is not None
            else float(hyp.get("alpha", 0.1))
        )
        self.burn_in_epochs = int(hyp["burn_in_epochs"])
        self.momentum = 1.0 - self.alpha
        self.wd = 1.0 / (self.prior_std ** 2)
        self.n_train = self.train.n
        self.burnt_in = False
        self.epochs_run = 0
        values = {
            "lr0": self.lr,
            "eta_min": eta_min_fraction * self.lr,
            "t_max": max(self.burn_in_epochs + self.num_samples, 1),
            "momentum": self.momentum,
            "wd_over_n": self.wd / self.n_train,
            "n_train": self.n_train,
        }
        for k, v in values.items():
            self._hyp[k].fill_(v)
        self._init_state()

    def _init_state(self):
        """Fresh weights, zero momentum, step 0, and fresh generators."""
        run = self.next_seed()
        init_variables(self.module, make_generator("cpu", run, "init"))
        self._state.momentum.zero_()
        self._state.grads.zero_()
        self._state.step = 0
        # permutations and crop/flip choices are drawn on the device; the
        # per-step noise seeds on the host, where the launch needs them
        self._data_gen = make_generator(self.device, run, "data")
        self._noise_gen = torch.Generator().manual_seed(derive_seed(run, "noise"))

    def update_hyp(self, hyperparameters: dict):
        """Reset weights and momentum and adopt new hyperparameters."""
        self._setup(hyperparameters, eta_min_fraction=self._ETA_MIN_FRACTION_UPDATE)

    # -- sampling ----------------------------------------------------------------

    def _run_epoch(self) -> torch.Tensor:
        split = self.train
        idx = epoch_indices(self._data_gen, split.n, split.batch_size)
        aug = (draw_augment(self._data_gen, tuple(idx.shape), split.spec)
               if split.spec.augments else None)
        seeds = torch.randint(0, 2 ** 63 - 1, (idx.shape[0],),
                              generator=self._noise_gen).tolist()
        loss = train_steps(
            self._state, self._images, self._labels, idx, spec=split.spec,
            epoch=self.epochs_run, noise_on=self._noise_on, hyp=self._hyp,
            lr_fn=self._LR_FN, update_fn=self._UPDATE_FN, seeds=seeds, aug=aug,
        )
        self.epochs_run += 1
        self.epoch_losses.append(loss)
        return loss

    def _harvest(self) -> dict:
        """A copy of the chain's current parameters and BatchNorm buffers."""
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def sample_iterative(self):
        epochs = self.burn_in_epochs + 1 if not self.burnt_in else 1
        self.burnt_in = True
        for _ in range(epochs):
            self._run_epoch()
        return self._harvest()

    def sample(self, num_samples=None) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples
        draws = [self.sample_iterative() for _ in range(num_samples)]
        return self._ensemble_from_draws(draws)

    def _ensemble_from_draws(self, draws) -> Ensemble:
        return Ensemble.from_list(self.module, draws)


class SGLD(SGHMC):
    """SGHMC with momentum pinned to 0."""

    _FORCE_ALPHA = 1.0
    _DEFAULT_HYP = {
        "lr": 0.001, "prior_std": 10, "num_samples": 2, "burn_in_epochs": 10,
    }
