"""SGD (the MAP baseline), DeepEnsemble and MCdropout samplers.

Counterpart of ``ursabench_tpu/inference/sgd_map.py``:
- SGD: SGD with momentum and weight decay, cosine annealing stepped per
  epoch (eta_min 0.01 * lr at construction, 0.5 * lr after
  ``update_hyp``), epochs + 1 epochs and then no more, ``num_samples``
  forced to 1.
- DeepEnsemble: K independently initialised SGD runs, as K chains of one
  sampler (``_EpochSampler``): ``sample()`` returns the K members, which a
  mesh shards over its chain ranks.
- MCdropout: the ``<Model>_dropout`` twin trained with SGD, a one-cycle
  learning rate stepped per batch and the dropout-lengthscale weight decay
  l^2 (1 - p) / (2 N); its S members share one set of weights (``expand``ed
  views) and differ by their dropout streams.

The update is the plain ``ops.sgmcmc.sgd_momentum_update`` over the flat
buffers: the JAX package has no Pallas kernel for it.
"""

from __future__ import annotations

import math

import torch

from ..models.common import dropout_twin
from ..ops.sgmcmc import sgd_momentum_update
from ..util import as_f32
from .base import _EpochSampler
from .engine import TrainState, update_buffers
from .ensemble import Ensemble
from .sgmcmc import _cosine_hyp_lr


def _sgd_hyp_update(state: TrainState, hyp, *, lr, noise_on, is_first_step, seed):
    """As ``_sghmc_hyp_update``: a sweep's (K,) hyperparameters act as (K, 1)
    columns on the (K, P) buffers."""
    del noise_on, seed
    col = (lambda t: t.reshape(-1, 1)) if hyp["momentum"].dim() else (lambda t: t)
    sgd_momentum_update(
        *update_buffers(state, hyp), lr=col(lr), momentum=col(hyp["momentum"]),
        weight_decay=col(hyp["weight_decay"]), is_first_step=is_first_step,
    )


def _one_cycle_hyp_lr(hyp, epoch, batch_idx, step):
    """torch OneCycleLR (cosine annealing) over the global step, reading
    (max_lr, initial_lr, min_lr, total_steps, up_steps, down_steps) from
    ``hyp``; float32, in the JAX package's order of operations."""
    del epoch, batch_idx
    s = torch.minimum(as_f32(step, hyp["total_steps"].device), hyp["total_steps"])
    t_up = torch.clamp(s / hyp["up_steps"], 0.0, 1.0)
    lr_up = hyp["initial_lr"] + (hyp["max_lr"] - hyp["initial_lr"]) * 0.5 * (
        1.0 - torch.cos(math.pi * t_up)
    )
    t_down = torch.clamp((s - hyp["up_steps"]) / hyp["down_steps"], 0.0, 1.0)
    lr_down = hyp["min_lr"] + (hyp["max_lr"] - hyp["min_lr"]) * 0.5 * (
        1.0 + torch.cos(math.pi * t_down)
    )
    return torch.where(s <= hyp["up_steps"], lr_up, lr_down)


def _one_cycle_values(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0, final_div_factor: float = 1e4) -> dict:
    """The hyperparameters of ``_one_cycle_hyp_lr``: torch OneCycleLR peaks
    at step int(pct * total) - 1 and ends at total - 1."""
    initial_lr = max_lr / div_factor
    up_steps = float(max(1, int(pct_start * total_steps) - 1))
    return {"max_lr": max_lr, "initial_lr": initial_lr,
            "min_lr": initial_lr / final_div_factor, "total_steps": float(total_steps),
            "up_steps": up_steps, "down_steps": max(1.0, (total_steps - 1) - up_steps)}


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4):
    """torch OneCycleLR (cosine annealing) as ``lr_fn(epoch, batch_idx,
    step)``."""
    hyp = {k: torch.tensor(v, dtype=torch.float32) for k, v in _one_cycle_values(
        max_lr, total_steps, pct_start, div_factor, final_div_factor).items()}
    return lambda epoch, batch_idx, step: _one_cycle_hyp_lr(hyp, epoch, batch_idx, step)


class SGD(_EpochSampler):
    _DEFAULT_HYP = {"lr": 0.1, "epochs": 10, "momentum": 0.9, "weight_decay": 0.001}
    _HYP_KEYS = ("lr0", "eta_min", "t_max", "momentum", "weight_decay")
    _LR_FN = staticmethod(_cosine_hyp_lr)
    _UPDATE_FN = staticmethod(_sgd_hyp_update)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._setup(hyperparameters, eta_min_fraction=0.01)

    def _setup(self, hyp, eta_min_fraction):
        self.hyperparameters = hyp
        self.lr = float(hyp["lr"])
        self.num_samples = 1
        self.burn_in_epochs = int(hyp["epochs"])
        self.momentum = float(hyp["momentum"])
        self.weight_decay = float(hyp["weight_decay"])
        self._fill_hyp({
            "lr0": self.lr,
            "eta_min": eta_min_fraction * self.lr,
            "t_max": max(self.burn_in_epochs + self.num_samples, 1),
            "momentum": self.momentum,
            "weight_decay": self.weight_decay,
        })
        self._noise_gate.fill_(0.0)
        self._init_state()

    def update_hyp(self, hyperparameters):
        self._setup(hyperparameters, eta_min_fraction=0.5)

    def sample_iterative(self, val_loader=None, debug_val_loss=False):
        epochs = self.burn_in_epochs + 1 if not self.burnt_in else 0
        self.burnt_in = True
        for _ in range(epochs):
            self._log_val_loss(self._run_epoch(), val_loader, debug_val_loss)
        return self._harvest()

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples
        draws = [self.sample_iterative(val_loader, debug_val_loss)
                 for _ in range(num_samples)]
        return self._ensemble_from_draws(draws)


class DeepEnsemble(SGD):
    """A deep ensemble of independently initialised MAP models: the members
    are the chains of one SGD sampler. hyp adds 'num_members' (default 5);
    the other keys are SGD's."""

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=None,
                 device=None, chain_strategy="auto", mesh=None):
        hyperparameters = dict(hyperparameters or {**SGD._DEFAULT_HYP, "num_members": 5})
        members = int(hyperparameters.get("num_members", 5))
        super().__init__(hyperparameters, model=model, train=train,
                         model_loss=model_loss, seed=seed, chains=chains or members,
                         device=device, chain_strategy=chain_strategy, mesh=mesh)

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        del num_samples  # one draw per member; the members are the chains
        return super().sample(1, val_loader, debug_val_loss)


class MCdropout(_EpochSampler):
    _DEFAULT_HYP = {
        "lr": 0.1, "epochs": 10, "dropout": 0.2, "lengthscale": 0.01,
        "num_samples": 10, "momentum": 0.9, "weight_decay": 0,
    }
    _HYP_KEYS = ("max_lr", "initial_lr", "min_lr", "total_steps", "up_steps",
                 "down_steps", "momentum", "weight_decay")
    _LR_FN = staticmethod(_one_cycle_hyp_lr)
    _UPDATE_FN = staticmethod(_sgd_hyp_update)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, model_name: str | None = None, chain_strategy="auto",
                 mesh=None):
        """``model`` may be a base module: pass ``model_name`` to build its
        ``_dropout`` twin from the registry with the base module's class
        count, in the registry's default compute dtype (float32) whatever
        the base's, as the JAX package builds it; or pass the twin itself
        (built in any dtype). ``mesh`` may be a data mesh, or a chain-only
        one over which the one chain is replicated, as in the JAX package:
        the members share chain 0's weights."""
        if mesh is not None and mesh.shape["chain"] > 1 and mesh.shape["data"] > 1:
            raise ValueError("MCdropout's members share one chain's weights: use a mesh "
                             f"with chain=1 (data parallelism), got {mesh.shape}")
        if model_name is not None:
            model = dropout_twin(model_name).build(getattr(model, "num_classes", None) or 10)
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._setup(hyperparameters)

    def _setup(self, hyp):
        self.hyperparameters = hyp
        self.lr = float(hyp["lr"])
        self.num_samples = int(hyp["num_samples"])
        self.burn_in_epochs = int(hyp["epochs"])
        self.dropout = float(hyp["dropout"])
        self.momentum = float(hyp["momentum"])
        if float(hyp.get("weight_decay", 0)) != 0:
            self.weight_decay = float(hyp["weight_decay"])
        else:  # the dropout-lengthscale decay
            self.weight_decay = (float(hyp["lengthscale"]) ** 2 * (1 - self.dropout)
                                 / (2.0 * self.train.n))
        total_steps = max((self.burn_in_epochs + self.num_samples) * self.train.num_batches, 2)
        self._fill_hyp({**_one_cycle_values(self.lr * 5, total_steps),
                        "momentum": self.momentum, "weight_decay": self.weight_decay})
        self._noise_gate.fill_(0.0)
        self._init_state()

    def update_hyp(self, hyperparameters):
        self._setup(hyperparameters)

    def sample_iterative(self, val_loader=None, debug_val_loss=False):
        epochs = self.burn_in_epochs + 1 if not self.burnt_in else 1
        self.burnt_in = True
        for _ in range(epochs):
            self._log_val_loss(self._run_epoch(), val_loader, debug_val_loss)
        return self._harvest()

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        """S members sharing the last weights (chain 0's), each with its
        own dropout stream."""
        if num_samples is None:
            num_samples = self.num_samples
        for _ in range(num_samples):
            self.sample_iterative(val_loader, debug_val_loss)
        shared = self._single_member()
        state = {k: v.expand((num_samples,) + tuple(v.shape)) for k, v in shared.items()}
        return Ensemble(self.module, state, num_samples, dropout_seed=self.next_seed(),
                        mesh=self.mesh, replicated=self.replicated)
