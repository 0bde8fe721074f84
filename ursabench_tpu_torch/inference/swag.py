"""SWAG: SWA-Gaussian posterior sampling.

Counterpart of ``ursabench_tpu/inference/swag.py``. By default this is
true SWAG: running moments over the iterates after burn-in (``burn_in +
num_iterates`` epochs on the first draw, one collection per epoch after
``burn_in``), and each draw ``mean + sqrt(var) * N(0, I)``, plus
``cov_mat_sqrt^T z / sqrt(max_rank - 1)`` with ``z ~ N(0, I_K)`` when
``full_cov``, each with its BatchNorm statistics refreshed.
``reference_bug_compat=True`` reproduces the shipped reference, whose
moments collapse to the last iterate and whose every draw is the mean.

The normals come from a generator on the device seeded from the sampler's
seed; ``normals=(eps, z)`` hands them in (for tests).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..util import make_generator, stack_state_dicts
from .ensemble import Ensemble
from .swa import SWA


class SWAG(SWA):
    _DEFAULT_HYP = {
        "swag_lr": 0.001, "swag_wd": 0.001, "lr_init": 0.001, "num_samples": 20,
        "momentum": 0.1, "burn_in_epochs": 100, "num_iterates": 50,
    }

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, reference_bug_compat: bool = False, mesh=None,
                 **subspace_kwargs):
        self.reference_bug_compat = reference_bug_compat
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, mesh, **subspace_kwargs)
        self.num_samples = int(self.hyperparameters.get("num_samples", 20))
        self.weight_variance = None

    def _setup(self, hyp):
        super()._setup(hyp)
        self._normal_gen = make_generator(self.device, self.next_seed(), "swag")

    def _collect_model_correct(self):
        """SWA's running moments, counting the model after it."""
        self._collect_model()
        self.num_models_collected += 1

    def _draw_weight_sample(self, full_cov: bool,
                            normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                            ) -> torch.Tensor:
        if self.reference_bug_compat:
            return self.weight_mean
        mean, var = self._get_mean_and_variance()
        eps = (torch.randn(mean.shape, generator=self._normal_gen, device=mean.device)
               if normals is None else normals[0])
        sample = mean + torch.sqrt(var) * eps
        cms = getattr(self.subspace, "cov_mat_sqrt", None)
        if full_cov and cms is not None and cms.shape[0] > 1:
            z = (torch.randn(cms.shape[0], generator=self._normal_gen, device=mean.device)
                 if normals is None else normals[1])
            sample = sample + (cms.T @ z) / ((self.subspace.max_rank - 1) ** 0.5)
        return sample

    def sample_iterative(self, update_bn=True, val_loader=None, debug_val_loss=False,
                         full_cov=False, normals=None):
        if not self.burnt_in:
            for epoch in range(self.burn_in_epochs + self.num_iterates):
                self._log_val_loss(self._run_epoch(), val_loader, debug_val_loss)
                if epoch >= self.burn_in_epochs:
                    if self.reference_bug_compat:
                        self._collect_model()  # n stays 0: the last iterate
                    else:
                        self._collect_model_correct()
            self.burnt_in = True
            _, self.weight_variance = self._get_mean_and_variance()
        return self._variables_at(self._draw_weight_sample(full_cov, normals), update_bn)

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False,
               full_cov=False) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples
        draws = [self.sample_iterative(update_bn=True, val_loader=val_loader,
                                       debug_val_loss=debug_val_loss, full_cov=full_cov)
                 for _ in range(num_samples)]
        return Ensemble(self.module, stack_state_dicts(draws), num_samples, mesh=self.mesh)
