"""SWA: stochastic weight averaging with a subspace of deviations.

Counterpart of ``ursabench_tpu/inference/swa.py``: SGD under a constant,
then linearly decaying, then constant learning rate; running first and
second moments of the flat weight vector; each deviation from the running
mean goes into a ``Subspace``; the ensemble is the SWA mean with its
BatchNorm statistics refreshed by one exact pass (on the last draw only).

The reference's quirk is kept: ``sample_iterative`` counts the model
before its epochs run, so the first average includes a phantom zero
vector (mean = w/2 after one collection). The variance is clamped at
``VAR_CLAMP``.

The flat weight vector is the sampler's flat parameter buffer
(``util.ravel`` order); a second module with its own flat buffer holds the
mean for the BatchNorm refresh, so the training iterate and its BatchNorm
buffers are never touched.

``mesh`` may be a data mesh only (chain 1): each SGD minibatch is sharded
over its data ranks, whose replicas of the trajectory and of its moments
stay equal. A mesh with a chain axis > 1 raises ValueError, as in the JAX
package: the trajectory is single.
"""

from __future__ import annotations

import copy

import torch

from ..util import StateDict
from .base import _EpochSampler
from .engine import bn_refresh, flatten_parameters
from .ensemble import Ensemble
from .sgd_map import _sgd_hyp_update
from .subspaces import Subspace


def _swa_schedule_hyp_lr(hyp, epoch, batch_idx, step):
    """The reference's ``_schedule``: lr_init up to half of burn_in, a
    linear decay to swag_lr up to 0.9 of it, then swag_lr."""
    del batch_idx, step
    t = float(epoch) / hyp["burn_in_epochs"]
    lr_ratio = hyp["swag_lr"] / hyp["lr_init"]
    factor = torch.where(
        t <= 0.5, torch.ones_like(t),
        torch.where(t <= 0.9, 1.0 - (1.0 - lr_ratio) * (t - 0.5) / 0.4, lr_ratio),
    )
    return hyp["lr_init"] * factor


class SWA(_EpochSampler):
    _DEFAULT_HYP = {
        "swag_lr": 0.001, "swag_wd": 0.001, "lr_init": 0.001, "num_samples": 20,
        "momentum": 0.1, "burn_in_epochs": 100, "num_iterates": 50,
    }
    VAR_CLAMP = 1e-30
    _HYP_KEYS = ("lr_init", "swag_lr", "burn_in_epochs", "momentum", "weight_decay")
    _LR_FN = staticmethod(_swa_schedule_hyp_lr)
    _UPDATE_FN = staticmethod(_sgd_hyp_update)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, mesh=None, **subspace_kwargs):
        if chains not in (1, None):
            raise NotImplementedError(
                "SWA/SWAG run a single trajectory (the running weight moments "
                "are chain-global); use SGHMC/SGLD/DeepEnsemble for chains")
        if mesh is not None and mesh.shape["chain"] > 1:
            raise ValueError("SWA/SWAG are single-trajectory: use a mesh with chain=1 "
                             f"(data parallelism), got {mesh.shape}; e.g. "
                             "parallel.make_mesh(chain_devices=1)")
        super().__init__(hyperparameters, model, train, model_loss, seed, 1, device, mesh=mesh)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._subspace_kwargs = dict(subspace_kwargs)
        # holds the SWA mean (or a SWAG draw) for its BatchNorm refresh
        self._eval_module = copy.deepcopy(self.module)
        self._eval_params, _ = flatten_parameters(self._eval_module)
        self._setup(hyperparameters)

    def _setup(self, hyp):
        self.hyperparameters = hyp
        self.burn_in_epochs = int(hyp["burn_in_epochs"])
        self.num_iterates = int(hyp["num_iterates"])
        self.num_samples = int(hyp.get("num_samples", self.num_iterates))
        self.momentum = float(hyp["momentum"])
        self.lr_init = float(hyp["lr_init"])
        self.swag_lr = float(hyp["swag_lr"])
        self.swag_wd = float(hyp["swag_wd"])
        self.subspace_type = hyp.get("subspace_type", "pca")
        self._init_state()
        self.num_parameters = self._state.params.shape[-1]
        self.weight_mean = torch.zeros(self.num_parameters, device=self.device)
        self.sq_mean = torch.zeros(self.num_parameters, device=self.device)
        self.num_models_collected = 0
        kwargs = dict(self._subspace_kwargs)
        if self.subspace_type == "random":  # the one space drawn up front
            kwargs.setdefault("device", self.device)
        self.subspace = Subspace.create(self.subspace_type,
                                        num_parameters=self.num_parameters, **kwargs)
        self.cov_factor = None
        self._fill_hyp({
            "lr_init": self.lr_init,
            "swag_lr": self.swag_lr,
            "burn_in_epochs": max(self.burn_in_epochs, 1),
            "momentum": self.momentum,
            "weight_decay": self.swag_wd,
        })
        self._noise_gate.fill_(0.0)

    def update_hyp(self, hyperparameters, **subspace_kwargs):
        if subspace_kwargs:
            self._subspace_kwargs = dict(subspace_kwargs)
        self._setup(hyperparameters)

    # -- moment collection -----------------------------------------------------

    def _iterate(self) -> torch.Tensor:
        """The current weights as one flat vector (a view)."""
        return self._state.params.view(-1)

    def _collect_model(self):
        # the first collection averages with a phantom zero: see the module
        # docstring
        w = self._iterate()
        n = float(self.num_models_collected)
        self.weight_mean = self.weight_mean * (n / (n + 1.0)) + w / (n + 1.0)
        self.sq_mean = self.sq_mean * (n / (n + 1.0)) + w ** 2 / (n + 1.0)
        self.subspace.collect_vector(w - self.weight_mean)

    def _get_mean_and_variance(self):
        variance = torch.clamp(self.sq_mean - self.weight_mean ** 2, min=self.VAR_CLAMP)
        return self.weight_mean, variance

    def fit(self):
        if self.cov_factor is None:
            self.cov_factor = self.subspace.get_space()

    def get_space(self, export_cov_factor=True):
        mean, variance = self._get_mean_and_variance()
        if not export_cov_factor:
            return mean, variance
        self.fit()
        return mean, variance, self.cov_factor

    # -- sampling --------------------------------------------------------------

    def _variables_at(self, w: torch.Tensor, update_bn: bool) -> StateDict:
        """A copy of the state dict with flat weights ``w`` and the current
        BatchNorm buffers, refreshed over the train split if
        ``update_bn``."""
        self._eval_params.copy_(w)
        with torch.no_grad():
            for name, buf in self.module.named_buffers():
                self._eval_module.get_buffer(name).copy_(buf)
        if update_bn:
            bn_refresh(self._eval_module, self.train, images=self._images)
        return {k: v.detach().clone() for k, v in self._eval_module.state_dict().items()}

    def sample_iterative(self, update_bn_swa=True, val_loader=None, debug_val_loss=False):
        epochs = self.burn_in_epochs + 1 if not self.burnt_in else 1
        self.burnt_in = True
        self.num_models_collected += 1  # before the epochs: the phantom zero
        for _ in range(epochs):
            self._log_val_loss(self._run_epoch(), val_loader, debug_val_loss)
        self._collect_model()
        return self._variables_at(self.weight_mean, update_bn=update_bn_swa)

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        """The final SWA mean, ``num_samples`` times (the reference returns
        the same module that many times)."""
        if num_samples is None:
            num_samples = self.num_iterates
        for i in range(num_samples):
            state = self.sample_iterative(update_bn_swa=(i == num_samples - 1),
                                          val_loader=val_loader,
                                          debug_val_loss=debug_val_loss)
        state = {k: v.expand((num_samples,) + tuple(v.shape)) for k, v in state.items()}
        return Ensemble(self.module, state, num_samples, mesh=self.mesh)
