"""SGHMC, SGLD, cSGHMC and cSGLD samplers.

Counterpart of ``ursabench_tpu/inference/sgmcmc.py``, which documents the
reference protocols:
- SGHMC: burn_in + 1 epochs before the first draw, then one epoch per draw;
  cosine annealing of the learning rate over burn_in + num_samples epochs,
  eta_min 0 at construction and lr/2 after ``update_hyp``; momentum =
  1 - alpha, weight decay = 1/prior_std**2; the Langevin noise is always on
  (the reference's gate is vacuous). SGLD is SGHMC with alpha pinned to 1.
- cSGHMC: a cyclic cosine learning rate stepped per batch, with the
  reference's float batch count; the noise is on only in the last
  burn_in + samples_per_cycle epochs of each cycle; a draw is harvested
  after each of the last samples_per_cycle epochs of a cycle. cSGLD is
  cSGHMC with alpha pinned to 1.

SGHMC and cSGHMC (and so SGLD and cSGLD) save a mid-chain checkpoint
after every epoch the schedule of ``enable_auto_checkpoint`` asks for.

With ``chains`` C, every epoch advances all C chains (``_EpochSampler``)
and each draw holds one member per chain: S draws make an ensemble of S * C
members, draw-major, as the JAX package merges them. With ``mesh`` (a
``parallel.Mesh``) the chains are sharded over its chain ranks and each
batch over its data ranks (``inference/engine.py``).

The hyperparameters live in 0-dim device tensors that ``update_hyp`` fills
in place, so changing them never rebuilds anything; the learning rate is
computed on the device in float32 from them, as the JAX package traces it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.sgmcmc import sghmc_update
from .base import _EpochSampler
from .engine import TrainState, update_buffers
from .ensemble import Ensemble


def _cosine_hyp_lr(hyp, epoch, batch_idx, step):
    """torch CosineAnnealingLR by epoch, reading (lr0, eta_min, t_max) from
    the device tensors in ``hyp``."""
    del batch_idx, step
    return hyp["eta_min"] + (hyp["lr0"] - hyp["eta_min"]) * 0.5 * (
        1.0 + torch.cos(math.pi * float(epoch) / hyp["t_max"])
    )


def _cyclic_hyp_lr(hyp, epoch, batch_idx, step):
    """cSGHMC's per-batch cyclic cosine, reading (lr0, num_batch,
    cycle_iters) from ``hyp``; float32 throughout, in the JAX package's
    order of operations."""
    del step
    rcounter = hyp["num_batch"] * float(epoch) + float(batch_idx)
    cos_inner = math.pi * torch.remainder(rcounter, hyp["cycle_iters"]) / hyp["cycle_iters"]
    return 0.5 * (torch.cos(cos_inner) + 1.0) * hyp["lr0"]


def _sghmc_hyp_update(state: TrainState, hyp, *, lr, noise_on, is_first_step, seed):
    """One update of every row: over the flat buffers with 0-dim
    hyperparameters, over the (K, P) buffers with a sweep's (K,) ones."""
    sghmc_update(
        *update_buffers(state, hyp), lr=lr,
        momentum=hyp["momentum"], wd_over_n=hyp["wd_over_n"],
        n_train=hyp["n_train"], noise_on=noise_on,
        is_first_step=is_first_step, seed=seed, **state.noise_block(),
    )


class SGHMC(_EpochSampler):
    _DEFAULT_HYP = {
        "lr": 0.001, "prior_std": 10, "num_samples": 2, "alpha": 0.1,
        "burn_in_epochs": 10,
    }
    _FORCE_ALPHA: Optional[float] = None  # SGLD pins this to 1.0
    _ETA_MIN_FRACTION_INIT = 0.0
    _ETA_MIN_FRACTION_UPDATE = 0.5
    _HYP_KEYS = ("lr0", "eta_min", "t_max", "momentum", "wd_over_n", "n_train")
    _LR_FN = staticmethod(_cosine_hyp_lr)
    _UPDATE_FN = staticmethod(_sghmc_hyp_update)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
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
        self._fill_hyp({
            "lr0": self.lr,
            "eta_min": eta_min_fraction * self.lr,
            "t_max": max(self.burn_in_epochs + self.num_samples, 1),
            "momentum": self.momentum,
            "wd_over_n": self.wd / self.n_train,
            "n_train": self.n_train,
        })
        self._noise_gate.fill_(1.0)  # always on
        self._init_state()

    def update_hyp(self, hyperparameters: dict):
        """Reset weights and momentum and adopt new hyperparameters."""
        self._setup(hyperparameters, eta_min_fraction=self._ETA_MIN_FRACTION_UPDATE)

    # -- sampling ----------------------------------------------------------------

    def sample_iterative(self, val_loader=None, debug_val_loss=False):
        epochs = self.burn_in_epochs + 1 if not self.burnt_in else 1
        self.burnt_in = True
        for _ in range(epochs):
            loss = self._run_epoch()
            self._maybe_checkpoint()
            self._log_val_loss(loss, val_loader, debug_val_loss)
        return self._harvest()

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples
        draws = [self.sample_iterative(val_loader, debug_val_loss)
                 for _ in range(num_samples)]
        return self._ensemble_from_draws(draws)


class SGLD(SGHMC):
    """SGHMC with momentum pinned to 0."""

    _FORCE_ALPHA = 1.0
    _DEFAULT_HYP = {
        "lr": 0.001, "prior_std": 10, "num_samples": 2, "burn_in_epochs": 10,
    }


class cSGHMC(_EpochSampler):
    _DEFAULT_HYP = {
        "lr_0": 0.001, "prior_std": 10.1, "num_samples_per_cycle": 5,
        "cycle_length": 20, "burn_in_epochs": 5, "num_cycles": 10, "alpha": 1.0,
    }
    _FORCE_ALPHA: Optional[float] = None
    _HYP_KEYS = ("lr0", "num_batch", "cycle_iters", "momentum", "wd_over_n", "n_train")
    _LR_FN = staticmethod(_cyclic_hyp_lr)
    _UPDATE_FN = staticmethod(_sghmc_hyp_update)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._setup(hyperparameters)

    def _setup(self, hyp: dict):
        self.hyperparameters = hyp
        self.lr_0 = float(hyp["lr_0"])
        self.prior_std = float(hyp["prior_std"])
        self.num_samples_per_cycle = int(hyp["num_samples_per_cycle"])
        self.cycle_length = int(hyp["cycle_length"])
        self.alpha = (
            self._FORCE_ALPHA if self._FORCE_ALPHA is not None
            else float(hyp.get("alpha", 1.0))
        )
        self.burn_in_epochs = int(hyp["burn_in_epochs"])
        self.num_cycles = int(hyp["num_cycles"])
        if self.cycle_length - self.burn_in_epochs - self.num_samples_per_cycle <= 0:
            raise ValueError("cycle_length must exceed burn_in_epochs + "
                             "num_samples_per_cycle")
        self.momentum = 1.0 - self.alpha
        self.wd = 1.0 / (self.prior_std ** 2)
        self.n_train = self.train.n
        # the reference's float batch count
        num_batch = max(1.0, self.n_train / self.train.batch_size + 1.0)
        total_iterations = self.cycle_length * self.num_cycles * num_batch
        self._fill_hyp({
            "lr0": self.lr_0,
            "num_batch": num_batch,
            "cycle_iters": total_iterations // self.num_cycles,
            "momentum": self.momentum,
            "wd_over_n": self.wd / self.n_train,
            "n_train": self.n_train,
        })
        self._init_state()

    def update_hyp(self, hyperparameters: dict):
        self._setup(hyperparameters)

    def _noise_on(self) -> bool:
        """The noise gate of the next epoch: on in the last burn_in +
        samples_per_cycle epochs of a cycle."""
        return (self.epochs_run % self.cycle_length) + 1 > (
            self.cycle_length - self.burn_in_epochs - self.num_samples_per_cycle
        )

    def _harvested(self) -> bool:
        """Whether the epoch just run ends with a draw (checked after the
        epoch counter increments)."""
        return ((self.epochs_run - 1) % self.cycle_length) >= (
            self.cycle_length - self.num_samples_per_cycle
        )

    def sample_iterative(self, val_loader=None, debug_val_loss=False):
        while True:
            loss = self._run_epoch(noise_on=self._noise_on())
            self._maybe_checkpoint()
            self._log_val_loss(loss, val_loader, debug_val_loss)
            if self._harvested():
                return self._harvest()

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples_per_cycle * self.num_cycles
        draws = [self.sample_iterative(val_loader, debug_val_loss)
                 for _ in range(num_samples)]
        return self._ensemble_from_draws(draws)


class cSGLD(cSGHMC):
    """cSGHMC with momentum pinned to 0."""

    _FORCE_ALPHA = 1.0
