"""The PCA-subspace elliptical slice sampler.

Counterpart of ``ursabench_tpu/inference/pca_subspace.py``: phase 1 runs
SWA and builds a rank-k PCA subspace of its trajectory; phase 2 runs
elliptical slice sampling (``ops.ess.elliptical_slice``) in the subspace's
coordinates, each chain from zero with ``prior_std * N(0, I)`` prior draws,
against the tempered log density ``-CE_sum / temperature`` over the train
split. Each draw maps back to weights ``mean + cov_factor^T theta`` with
the SWA's trained BatchNorm statistics; the last draw gets a BatchNorm
refresh.

The log density runs the network in train mode (batch statistics) over
``train.batch_size`` batches, the last one filled up with index 0: those
rows enter the batch statistics, as in the JAX package, and are masked out
of the cross entropy. It runs on the SWA's evaluation module, whose
running statistics the train-mode forwards overwrite and which
``SWA._variables_at`` copies again from the trained ones before every
member: the trained statistics themselves are never written. Every bracket
proposal is one full-data pass and one host read. The pass is a program
(``engine.make_potential_fn``'s "density" variant, the counterpart of the
densities inside the JAX package's compiled transition, off a mesh and on
one: ``step_program`` ``"graph"``): the weights are copied into
a static buffer and one batch's step (gather by a device counter,
normalize, the train-mode forward, the masked CE sum) is replayed once a
batch, captured once as a CUDA graph on the card and run eagerly on the
CPU; one program serves ``lnpdf`` and one each row count of
``lnpdf_chains``. The bracket loop stays on the host: its trip count
depends on the data. ``_plain_lnpdf`` and ``_plain_lnpdf_chains`` run the
same steps from Python: the programs' plain versions (run only where a
test hides the programs).

Each chain draws its prior samples and bracket uniforms from its own CPU
generator (seeded ``derive_seed(run, "ess", c)``, the counterpart of the JAX
package's per-chain keys). With ``chain_strategy`` ``"scan"`` the chains'
bracket loops run in turn (``ops.ess.elliptical_slice``); with ``"vmap"``
they run in lock step (``ops.ess.elliptical_slice_chains``): one batched
log density (``lnpdf_chains``, ``engine.ChainForward`` with the batch
statistics returned, never written) over the chains still bracketing and
one host read a proposal for all of them. On the same streams the two give
the same draws. A checkpoint (``enable_auto_checkpoint``, counted in draws)
holds the subspace, the trained BatchNorm statistics, the ESS state, the
generators and each draw's coordinates: a resumed run skips phase 1 and
reprojects the draws it already has.

On a device mesh (``mesh``), as in the JAX package: the SWA phase gets the
mesh when its chain axis is 1 (a data-parallel SWA) and otherwise runs
whole on every rank; the ESS chains block over 'chain' (``mesh.
chain_block``) where the chain axis divides them and are otherwise
replicated, every chain row running all of them (the JAX package's
``c_ax = None``), each chain with its generator ``ess<c>`` of its global
chain id; the log density is data-parallel, each data rank taking its
columns of every batch (the batch rounded down to a multiple of the data
axis: the density's program replays over the rank's columns) and one
all-reduce over 'data', outside any graph, summing the cross entropy,
once a density as the JAX package's one ``psum``. ESS has no gradient, so
that value is the whole of the reduction. The data-parallel SWA phase
runs its epochs through the sharded epoch program. The batch
statistics are then
each data rank's own, as under JAX's ``shard_map``: on a BatchNorm net a
data mesh evaluates another (local-statistics) density than one process.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from ..data.transforms import normalize
from ..models.common import dropout_generator, dropout_layers
from ..ops.ess import elliptical_slice, elliptical_slice_chains
from ..util import derive_seed, make_generator, stack_state_dicts
from .base import _Inference
from .engine import (ChainForward, _sharded_batches, live_pool, make_potential_fn,
                     stacked_views)
from .ensemble import Ensemble
from .subspaces import SubspaceModel
from .swa import SWA

class PCASubspaceSampler(_Inference):
    _DEFAULT_HYP = {
        "swag_lr": 0.001, "swag_wd": 0.001, "lr_init": 0.001, "num_samples": 20,
        "swag_momentum": 0.1, "swag_burn_in_epochs": 100, "num_swag_iterates": 50,
        "rank": 20, "max_rank": 20, "temperature": 5000, "prior_std": 2.0,
    }

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._resume_state = None
        self._setup(hyperparameters)

    def _replicates(self, mesh) -> bool:
        return True

    def _setup(self, hyp):
        self.hyperparameters = hyp
        self.rank = int(hyp["rank"])
        self.max_rank = int(hyp["max_rank"])
        self.num_samples = int(hyp["num_samples"])
        self.prior_std = float(hyp["prior_std"])
        self.temperature = float(hyp["temperature"])
        swa_hyp = {
            "burn_in_epochs": int(hyp["swag_burn_in_epochs"]),
            "momentum": float(hyp["swag_momentum"]),
            "lr_init": float(hyp["lr_init"]),
            "swag_lr": float(hyp["swag_lr"]),
            "swag_wd": float(hyp["swag_wd"]),
            "num_iterates": int(hyp["num_swag_iterates"]),
            "subspace_type": "pca",
        }
        # the SWA phase is one trajectory: data-parallel on a mesh without a chain axis
        swa_mesh = self.mesh if self.mesh is not None and self.mesh.shape["chain"] == 1 else None
        self.swa = SWA(swa_hyp, model=self.module, train=self.train, seed=self.next_seed(),
                       device=self.device, max_rank=self.max_rank, pca_rank=self.rank,
                       mesh=swa_mesh)
        run = self.next_seed()
        self._gens = [torch.Generator().manual_seed(derive_seed(run, "ess", c))
                      for c in self.chain_ids]
        batches = _sharded_batches(self.train.n, self.train.batch_size, self.mesh, self.device)
        self._valid = (batches >= 0).to(torch.float32)
        self._batches = batches.clamp_min(0)
        self._has_dropout = bool(dropout_layers(self.module))
        self._forward = ChainForward(self.swa._eval_module)
        self._programs: dict = {}  # rows (None: lnpdf) -> make_potential_fn's program
        self.subspace_constructed = False
        self.subspace = None
        self.current_theta = None
        self.current_lnpdf = None
        self.bracket_iters: list = []  # per draw, each chain's proposals
        self.draws_done = 0

    def update_hyp(self, hyperparameters):
        self._setup(hyperparameters)

    # -- the tempered full-data log density -------------------------------------

    def density_program(self, rows: Optional[int]):
        """The log density's program (``engine.make_potential_fn``'s
        "density" variant: on the card one batch's step captured once and
        replayed a batch at a time, on the CPU run eagerly; on a data mesh
        over this rank's columns): on the SWA's evaluation module's own
        flat weights (``rows`` None, ``lnpdf``), or on a static (rows, P)
        buffer as one ``ChainForward`` (``lnpdf_chains`` at ``rows``
        chains). One program a row count, built at first use and kept
        across draws; they share the pool of one that is captured (they
        never run at once)."""
        prog = self._programs.get(rows)
        if prog is None:
            ref = weakref.ref(self)  # no cycle between the sampler and its programs
            module, flat, views = self.swa._eval_module, self.swa._eval_params, None
            if rows is not None:
                flat = torch.zeros(rows, flat.numel(), device=self.device)
                views = stacked_views(module, flat)
            prog = self._programs[rows] = make_potential_fn(
                module, self.swa._images, self.swa._labels, self.train.spec, self._batches,
                self._valid, variant="density", flat=flat, views=views,
                pool=lambda: live_pool(ref()._programs.values()))
        return prog

    @torch.no_grad()
    def lnpdf(self, theta: torch.Tensor) -> torch.Tensor:
        """``-CE_sum / temperature`` at subspace coordinates ``theta``
        (rank,), a 0-dim tensor on the device: ``density_program(None)`` at
        the weights ``mean + cov_factor^T theta`` and its all-reduce over
        'data', or ``_plain_lnpdf`` where a test hides the program."""
        prog = self.density_program(None)
        if prog is None:
            return self._plain_lnpdf(theta)
        return -self._over_data(prog(self.subspace(theta))) / self.temperature

    @torch.no_grad()
    def lnpdf_chains(self, theta: torch.Tensor) -> torch.Tensor:
        """``lnpdf`` at every row of ``theta`` (C', rank) at once, a (C',)
        tensor: ``density_program(C')``, one batched train-mode forward a
        batch of the split whose batch statistics are returned, not
        written, and its all-reduce over 'data', or ``_plain_lnpdf_chains``
        where a test hides the program. A lock-step draw's C' shrinks
        proposal by proposal, and each C' has its program: the batched
        forward keeps the shape (and so the bits) of the plain version at
        C'."""
        prog = self.density_program(theta.shape[0])
        if prog is None:
            return self._plain_lnpdf_chains(theta)
        total = prog(self.subspace.mean + theta @ self.subspace.cov_factor)
        return -self._over_data(total) / self.temperature

    @torch.no_grad()
    def _plain_lnpdf(self, theta: torch.Tensor) -> torch.Tensor:
        """``lnpdf``'s plain version, a batch at a time from Python."""
        module = self.swa._eval_module
        self.swa._eval_params.copy_(self.subspace(theta))
        module.train()
        images, labels = self.swa._images, self.swa._labels
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for bi in range(self._batches.shape[0]):
            b = self._batches[bi]
            x = normalize(images.index_select(0, b), self.train.spec)
            gen = make_generator(self.device, 0, bi) if self._has_dropout else None
            with dropout_generator(module, gen):
                logits = module(x.permute(0, 3, 1, 2).contiguous())
            ce = F.cross_entropy(logits.to(torch.float32), labels.index_select(0, b),
                                 reduction="none")
            total = total + torch.sum(ce * self._valid[bi])
        return -self._over_data(total) / self.temperature

    @torch.no_grad()
    def _plain_lnpdf_chains(self, theta: torch.Tensor) -> torch.Tensor:
        """``lnpdf_chains``' plain version, a batch at a time from Python."""
        module = self.swa._eval_module
        weights = self.subspace.mean + theta @ self.subspace.cov_factor  # (C', P)
        params = stacked_views(module, weights)
        module.train()
        images, labels = self.swa._images, self.swa._labels
        chains = theta.shape[0]
        total = torch.zeros(chains, dtype=torch.float32, device=self.device)
        for bi in range(self._batches.shape[0]):
            b = self._batches[bi]
            x = normalize(images.index_select(0, b), self.train.spec)
            x = x.permute(0, 3, 1, 2).contiguous()
            layers, masks = ((), ())
            if self._has_dropout:  # one stream for every chain, as in lnpdf
                layers, masks = self._forward.masks(x, [make_generator(self.device, 0, bi)])
            logits, _ = self._forward(params, x, x_batched=False, layers=layers, masks=masks)
            y = labels.index_select(0, b).repeat(chains)
            ce = F.cross_entropy(logits.to(torch.float32).flatten(0, 1), y,
                                 reduction="none").view(chains, -1)
            total = total + torch.sum(ce * self._valid[bi], dim=1)
        return -self._over_data(total) / self.temperature

    def _over_data(self, total: torch.Tensor) -> torch.Tensor:
        """The CE sums of this rank's rows summed over 'data' (one
        all-reduce on a data mesh)."""
        return total if self.mesh is None else self.mesh.all_reduce(total, "data")

    def _set_subspace(self, mean: torch.Tensor, cov_factor: torch.Tensor) -> None:
        self.subspace = SubspaceModel(mean.to(self.device), cov_factor.to(self.device))
        self.current_theta = torch.zeros(len(self.chain_ids), self.subspace.rank,
                                         device=self.device)
        self.current_lnpdf = None
        self.subspace_constructed = True

    # -- sampling ----------------------------------------------------------------

    def _project_draw(self, theta: torch.Tensor, update_bn: bool):
        """Subspace coordinates (C, rank) -> the draw's state dict, with a
        leading chain axis when there is more than one chain."""
        states = [self.swa._variables_at(self.subspace(t), update_bn=update_bn)
                  for t in theta]
        return states[0] if self.chains == 1 else stack_state_dicts(states)

    def sample_iterative(self, update_bn=True, val_loader=None, debug_val_loss=False):
        """One ESS draw per chain (this rank's, on a mesh) in the shared
        subspace (phase 1 first, if it has not run)."""
        if not self.subspace_constructed:
            self.swa.sample()
            mean, _, cov_factor = self.swa.get_space()
            self._set_subspace(mean, cov_factor)
        prior = torch.stack([self.prior_std * torch.randn(self.subspace.rank, generator=g)
                             for g in self._gens]).to(self.device)
        lock_step = self._resolved_chain_strategy == "vmap"
        if self.current_lnpdf is None:
            self.current_lnpdf = (self.lnpdf_chains(self.current_theta) if lock_step else
                                  torch.stack([self.lnpdf(t) for t in self.current_theta]))
        if lock_step:
            theta, lp, iters = elliptical_slice_chains(
                self.current_theta, prior, self.lnpdf_chains, self.current_lnpdf,
                generators=self._gens)
        else:
            out = [elliptical_slice(self.current_theta[c], prior[c], self.lnpdf,
                                    self.current_lnpdf[c], generator=self._gens[c])
                   for c in range(len(self._gens))]
            theta, lp, iters = (torch.stack([o[0] for o in out]),
                                torch.stack([o[1] for o in out]), [o[2] for o in out])
        self.current_theta, self.current_lnpdf = theta, lp
        self.bracket_iters.append(iters)
        return self._project_draw(self.current_theta, update_bn)

    def sample(self, num_samples=None, val_loader=None, debug_val_loss=False) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples
        r = self._resume_state
        if r is not None and r["draw_thetas"].shape[0] <= num_samples:
            draw_thetas = self._resume()
        else:
            draw_thetas = []
        # the final draw carries the BatchNorm refresh, also when the
        # checkpoint already holds every draw
        draws = [self._project_draw(t, update_bn=(len(draw_thetas) == num_samples
                                                  and i == num_samples - 1))
                 for i, t in enumerate(draw_thetas)]
        while len(draws) < num_samples:
            draws.append(self.sample_iterative(update_bn=len(draws) == num_samples - 1))
            draw_thetas.append(self.current_theta)
            self.draws_done = len(draws)
            self._save_chain(draw_thetas)
        return self._ensemble_from_draws(draws)

    # -- mid-chain checkpoints ----------------------------------------------------

    def _chain_generators(self):
        return {"ess": self._gens}

    def _restore_checkpoint(self, path: str) -> None:
        from ..utils_checkpoint import load_pytree

        self._resume_state = load_pytree(path)
        self.draws_done = int(self._resume_state["draw_thetas"].shape[0])

    def _save_chain(self, draw_thetas) -> None:
        if not self._checkpoint_due(len(draw_thetas)):
            return
        from ..utils_checkpoint import save_chain_state

        save_chain_state(self._ckpt_path, self, {
            "mean": self.subspace.mean, "cov_factor": self.subspace.cov_factor,
            "batch_stats": dict(self.module.named_buffers()),
            "theta": self.current_theta, "lnpdf": self.current_lnpdf,
            "draw_thetas": torch.stack(draw_thetas),
        }, {"theta": 0, "lnpdf": 0, "draw_thetas": 1})

    def _resume(self) -> list:
        """The subspace, the trained BatchNorm statistics and the ESS state
        from the checkpoint; returns the coordinates already drawn."""
        from ..utils_checkpoint import chain_block, copy_into, restore_generators

        r, self._resume_state = self._resume_state, None

        def to(a, dim=None):  # this rank's chains of a chain-indexed array
            return torch.from_numpy(a if dim is None else chain_block(self, a, dim)
                                    ).to(self.device)

        self._set_subspace(to(r["mean"]), to(r["cov_factor"]))
        for name, value in r.get("batch_stats", {}).items():
            copy_into(self.module.get_buffer(name), value, name)
        self.current_theta, self.current_lnpdf = to(r["theta"], 0), to(r["lnpdf"], 0)
        restore_generators(self, r["generators"])
        return list(to(r["draw_thetas"], 1))
