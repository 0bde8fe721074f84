"""Multi-config sweeps of the epoch-driven samplers.

Counterpart of ``ursabench_tpu/inference/vectorized.py``. K configurations
of one sampler (SGHMC, SGLD, cSGHMC, cSGLD or SGD) advance together: each
config is a row of one (K, P) parameter buffer, as a sampler's chains are
(``engine.flatten_chains``), and its hyperparameters are row k of (K,)
device tensors, so one update a step serves every config (on the GPU, one
launch of kernel K1 with its per-row table; the (K,) learning rates come
from the same schedule on the (K,) tensors). ``chain_strategy`` decides how
the configs' forwards and backwards run, as it does for chains: in turn
(``"scan"``) or as one batched forward and backward (``"vmap"``, the JAX
package's ``vmap_hyp``), resolved for K rows (``base.resolve_chain_strategy``).

One solo sampler is built per config, with the seed ``derive_seed(seed,
"config", k)`` (the counterpart of ``jax.random.split(key, K)``): it supplies
config k's initial weights, hyperparameter tensors, batch plans, crops,
flips and dropout stream. Config 0's sampler then takes the K configs as its
chains and runs the method's own epochs and protocol over them, so config k
of a sweep equals its solo sampler exactly while the noise gate is off. The
Langevin noise of a step is one draw over the whole buffer (row k from flat
indices k * P + j), so with the noise on the two agree in distribution only.
The configs share the schedule's integers (``_SHARED_FIELDS``); continuous
hyperparameters vary freely.

With ``mesh`` the K configurations are the rows of its chain axis, as the
JAX package's sharded ``vmap_hyp`` epoch lays them out: a rank builds the
solo samplers of its block of configs only, trains them on its data slice
of every batch, and its K1 launch draws its rows' block of the noise (the
step's seed is config 0's on every rank). ``sample()`` returns the rank's
configs' ensembles; ``objectives`` returns all K on every rank.
"""

from __future__ import annotations

import copy
import time
from typing import List, Sequence

import torch

from ..util import derive_seed
from .base import check_mesh, resolve_chain_strategy
from .engine import TrainState, flatten_chains
from .ensemble import Ensemble

_METHODS = ("SGHMC", "SGLD", "cSGHMC", "cSGLD", "SGD")

# schedule fields every config of a sweep must share, per method
_SHARED_FIELDS = {
    "SGHMC": ("num_samples", "burn_in_epochs"),
    "SGLD": ("num_samples", "burn_in_epochs"),
    "cSGHMC": ("num_samples_per_cycle", "cycle_length", "burn_in_epochs", "num_cycles"),
    "cSGLD": ("num_samples_per_cycle", "cycle_length", "burn_in_epochs", "num_cycles"),
    "SGD": ("burn_in_epochs",),
}


def _method_class(name: str):
    from . import sgd_map, sgmcmc

    classes = {"SGHMC": sgmcmc.SGHMC, "SGLD": sgmcmc.SGLD, "cSGHMC": sgmcmc.cSGHMC,
               "cSGLD": sgmcmc.cSGLD, "SGD": sgd_map.SGD}
    if name not in classes:
        raise ValueError(f"unknown sweep method {name!r}; supported: {_METHODS}")
    return classes[name]


class MethodSweep:
    """K configurations of one epoch-driven sampler, advanced together.

    ``hyp_list`` holds one hyperparameter dict per config; ``model`` is
    copied once per config. ``sampler`` is config 0's sampler with the K
    configs as its chains: their weights in one (K, P) buffer, their
    hyperparameters as (K,) tensors, each row with its own solo sampler's
    data and dropout generators. ``sample()`` runs the method's protocol on
    it and returns K ensembles; ``objectives(task_factory)`` scores them.
    ``seconds`` holds the last ``objectives`` call's sampling and BMA
    seconds. On a mesh, ``configs`` are this rank's (global indices) and
    ``modules``, ``sampler`` and ``sample()`` hold those only."""

    def __init__(self, hyp_list: Sequence[dict], model=None, train=None, seed: int = 0,
                 method: str = "SGHMC", chain_strategy: str = "auto", mesh=None,
                 device=None):
        if len(hyp_list) < 1:
            raise ValueError("a sweep needs at least one configuration")
        self.K = len(hyp_list)
        self.mesh = check_mesh(mesh, self.K, getattr(train, "batch_size", None))
        self.configs = range(self.K) if self.mesh is None else self.mesh.chain_block(self.K)
        cls = _method_class(method)
        self.method = method
        self.hyp_list = [dict(h) for h in hyp_list]
        solos = [cls(self.hyp_list[k], model=copy.deepcopy(model), train=train,
                     seed=derive_seed(seed, "config", k), device=device,
                     chain_strategy=chain_strategy)
                 for k in self.configs]
        sampler = self.sampler = solos[0]
        for s in solos[1:]:
            for f in _SHARED_FIELDS[method]:
                if getattr(s, f) != getattr(sampler, f):
                    raise ValueError(f"sweep configs must share {f!r}: "
                                     f"{getattr(s, f)} != {getattr(sampler, f)}")
        self.device = sampler.device
        self.modules = [s.module for s in solos]
        params, grads = flatten_chains(self.modules)  # each config keeps its weights
        sampler.chains, sampler.modules = self.K, self.modules
        sampler.mesh, sampler.chain_ids = self.mesh, self.configs
        local = len(self.configs)
        sampler._resolved_chain_strategy = (
            resolve_chain_strategy(chain_strategy, sampler.module, train.spec.shape, local)
            if local > 1 else None)
        sampler._state = TrainState(self.modules[0], params, torch.zeros_like(params), grads,
                                    modules=self.modules, row_offset=self.configs[0],
                                    total_rows=self.K)
        sampler._hyp = {k: torch.stack([s._hyp[k] for s in solos]) for k in cls._HYP_KEYS}
        sampler._data_gens = [s._data_gens[0] for s in solos]
        sampler._dropout_gens = [(s._dropout_gens[0][0], 1) for s in solos]
        sampler._dropout_rows = slice(None)
        if self.configs[0]:  # every rank's steps take config 0's noise seeds
            run0 = sampler.run_seed(derive_seed(seed, "config", 0), sampler._draws)
            sampler._noise_gen = sampler._noise_generator(run0)
        self.seconds: dict = {}

    def sample(self) -> List[Ensemble]:
        """Every config's ensemble, by the method's own ``sample()``: its
        draw-major members, split by config."""
        ens, K = self.sampler.sample(), len(self.configs)
        return [Ensemble(self.modules[k], {n: v[k::K].contiguous() for n, v in ens.state.items()},
                         ens.num_members // self.K, mesh=self.mesh)
                for k in range(K)]

    def objectives(self, task_factory) -> List[float]:
        """Each config's ensemble scored by a fresh ``task_factory()`` (a
        single-metric task, in output_performance mode)."""
        t0 = time.perf_counter()
        ensembles = self.sample()
        self._sync()
        t1 = time.perf_counter()
        objs = []
        for ens in ensembles:
            task = task_factory()
            task.reset()
            objs.append(task.update_statistics(ens, output_performance=True))
        if self.mesh is not None:  # every rank's configs, in config order
            objs = self.mesh.chain_rows(torch.tensor(objs, dtype=torch.float64,
                                                     device=self.device)).tolist()
        self._sync()
        self.seconds = {"sample": t1 - t0, "bma": time.perf_counter() - t1}
        return objs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class SGHMCSweep(MethodSweep):
    """``MethodSweep(method="SGHMC")``."""

    def __init__(self, hyp_list: Sequence[dict], model=None, train=None, seed: int = 0,
                 device=None, mesh=None):
        super().__init__(hyp_list, model=model, train=train, seed=seed, method="SGHMC",
                         device=device, mesh=mesh)
