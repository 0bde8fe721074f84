"""Sampler protocol: the constructor takes (hyperparameters, model, train
split); ``update_hyp`` re-initialises; ``sample_iterative`` returns one
posterior draw; ``sample`` returns the ``Ensemble``.

Counterpart of ``ursabench_tpu/inference/base.py``, plus the chain
bookkeeping that every epoch-driven sampler of
``ursabench_tpu/inference/{sgmcmc,sgd_map,swa}.py`` shares
(``_EpochSampler``). Randomness comes from ``seed`` through generators
seeded with sha256-derived sub-seeds, one per purpose, where the JAX
package splits a PRNG key.

``mesh`` (a ``parallel.Mesh`` of the process group) shards the chains over
its chain ranks and every batch over its data ranks. A rank holds the block
of ``chains / chain`` chains ``mesh.chain_block`` gives, and each keeps its
global identity: its initial weights, batch plans, crops, flips and dropout
seeds are those chain c draws in one process, and K1 draws its block of the
noise (``TrainState.row_offset``). The rank's block advances by the
one-device ``chain_strategy`` rule for its own chain count (the JAX
package's local decision). A mesh of one rank is no mesh; a rank outside
the mesh (``mesh.active`` False) runs no sampler (ValueError).

Where the chain axis does not divide the chains, a sampler replicates them
where the JAX package runs them unplaced or replicated (``_replicates``),
and raises otherwise: every chain rank then holds every chain
(``replicated``), each drawing what one process draws. The epoch samplers
replicate one chain on a mesh whose data axis is 1; HMC replicates one
chain on any mesh, and the PCA subspace sampler any number of chains.

Mid-chain checkpoints (``enable_auto_checkpoint``): an epoch sampler saves
its chain state every N epochs (``utils_checkpoint.save_sampler_state``)
and restores it at once; HMC and the PCA subspace sampler save theirs every
N draws and resume inside ``sample()``. On a mesh rank 0 writes the file of
one process, gathered from every chain rank, and each rank restores its
own block; generators are named by global chain id.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import torch

from .. import tracing
from ..data.transforms import draw_augment
from ..models.common import dropout_layers
from ..util import StateDict, derive_seed, make_generator, stack_state_dicts
from .engine import (TrainState, epoch_indices, flatten_chains, init_variables,
                     make_epoch_fn, make_eval_loss_fn, stream_steps, train_steps)
from .ensemble import Ensemble, image_flops


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (CUDA when None). Raises when CUDA
    is asked for and absent: nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


# "auto"'s thresholds: one image's forward FLOPs (FlopCounterMode's count,
# two a multiply-add) up to which vmap wins at C >= 2 and at C >= 8 chains.
# Measured by chip_smoke.py's "chains" phase on an NVIDIA H100 80GB HBM3 at
# 700.00 W (the first column of PERF.md section 6's table), SGHMC at batch 128,
# vmap over scan
# aggregate step-forwards/s at C = 1 / 2 / 4 / 8: MLP200MNIST 0.57 / 1.06 /
# 1.93 / 3.05, LeNet5MNIST (0.83 MFLOP) 0.62 / 1.03 / 1.74 / 3.19,
# PreResNet-20 fp32 (82 MFLOP) 0.58 / 0.77 / 1.06 / 1.64, WideResNet-28x10
# bf16 (11.9 GFLOP) 0.69 / 0.56 / 0.66 at C = 1 / 2 / 4.
VMAP_IMAGE_FLOPS = {2: 2e6, 8: 2e8}


def resolve_chain_strategy(strategy: str, module, spec_shape, chains: int = 2) -> str:
    """``"scan"`` or ``"vmap"`` for ``chains`` chains of ``module`` on inputs
    of ``spec_shape`` (H, W, channels): how they advance on one device.
    Either way one update serves every chain a step. ``"scan"`` runs the
    chains' forwards and backwards in turn; ``"vmap"`` runs one batched
    forward and backward over chain-stacked weights, where a convolution
    becomes a grouped one. ``"auto"``, from the card's measurements
    (``VMAP_IMAGE_FLOPS``): vmap without convolution kernels (the MLPs) and,
    with them, while one image's forward stays within the threshold of the
    chain count (LeNet5 from 2 chains, PreResNet-20 from 8); scan above
    (WideResNet-28x10), where the grouped convolutions cost more than the
    launches vmap saves."""
    if strategy not in ("auto", "scan", "vmap"):
        raise ValueError(f"unknown chain_strategy {strategy!r}")
    if strategy != "auto":
        return strategy
    if not any(p.dim() == 4 for p in module.parameters()):
        return "vmap"
    limit = max((f for c, f in VMAP_IMAGE_FLOPS.items() if chains >= c), default=0.0)
    return "vmap" if limit and image_flops(module, spec_shape) <= limit else "scan"


def check_mesh(mesh, chains: int, batch_size: Optional[int], replicate: bool = False):
    """``mesh`` for a sampler of ``chains`` chains, or None for no mesh (or
    one of a single rank). Raises on a rank outside the mesh, where its
    chain axis does not divide ``chains`` (unless the sampler
    ``replicate``s them) or where its data axis does not divide the
    batch."""
    if mesh is not None and not mesh.active:
        raise ValueError(f"rank {mesh.rank} lies outside the mesh of {mesh.size} ranks: "
                         "it runs no sampler")
    if mesh is None or mesh.size == 1:
        return None
    if chains % mesh.shape["chain"] and not replicate:
        raise ValueError(f"{chains} chains do not split over a chain axis of "
                         f"{mesh.shape['chain']}")
    if batch_size is not None and batch_size % mesh.shape["data"]:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"{mesh.shape['data']} data ranks")
    return mesh


class _Inference:
    # how the steps run: through the captured programs of ``engine``, off a
    # mesh and on every mesh (``_EpochSampler``'s docstring)
    step_program = "graph"

    def __init__(
        self,
        hyperparameters: Optional[dict],
        model=None,  # torch module
        train=None,  # DataSplit
        model_loss: str = "multi_class_linear_output",
        seed: int = 0,
        chains: int = 1,
        device=None,
        chain_strategy: str = "auto",
        mesh=None,
    ):
        if model_loss != "multi_class_linear_output":
            raise NotImplementedError(model_loss)
        if int(chains) < 1:
            raise ValueError(f"chains must be >= 1, got {chains}")
        self.chains = int(chains)
        # every chain rank holds every chain: the chain axis does not divide them
        self.replicated = (mesh is not None and mesh.size > 1
                           and self.chains % mesh.shape["chain"] != 0 and self._replicates(mesh))
        self.mesh = check_mesh(mesh, self.chains, getattr(train, "batch_size", None),
                               self.replicated)
        # this rank's chains, as global indices (all of them without a mesh
        # or replicated over it)
        self.chain_ids = (range(self.chains) if self.mesh is None or self.replicated
                          else self.mesh.chain_block(self.chains))
        self.chain_strategy = chain_strategy
        self.device = resolve_device(device)
        self.module = model.to(self.device)
        self.train = train
        self.model_loss = model_loss
        self.seed = int(seed)
        # the resolved strategy of this rank's chains (None for one), as the
        # JAX package records it
        local = len(self.chain_ids)
        self._resolved_chain_strategy = (
            resolve_chain_strategy(chain_strategy, self.module, train.spec.shape, local)
            if local > 1 else None)
        self.hyperparameters = hyperparameters
        self._draws = 0
        self._ckpt_path: Optional[str] = None
        self._ckpt_every = 1
        self._val_loss_programs: dict = {}  # id(split) -> (split, make_eval_loss_fn's program)

    def _replicates(self, mesh) -> bool:
        """Whether the sampler holds all its chains on every chain rank of
        ``mesh``, whose chain axis does not divide them, where it would
        otherwise raise: one chain on a mesh without a data axis, which the
        JAX package's epoch samplers leave unplaced and run whole."""
        return self.chains == 1 and mesh.shape["data"] == 1

    # -- protocol ------------------------------------------------------------

    def update_hyp(self, hyperparameters: dict):
        raise NotImplementedError

    def sample_iterative(self):
        raise NotImplementedError

    def sample(self, num_samples: Optional[int] = None) -> Ensemble:
        raise NotImplementedError

    # -- shared helpers --------------------------------------------------------

    @staticmethod
    def run_seed(seed: int, draw: int) -> int:
        """The ``draw``-th ``next_seed`` of a sampler seeded with ``seed``."""
        return derive_seed(seed, "draw", draw)

    def next_seed(self) -> int:
        """A fresh sub-seed of ``seed`` (the counterpart of splitting the
        sampler's PRNG key)."""
        self._draws += 1
        return self.run_seed(self.seed, self._draws)

    def fresh_variables(self, module=None, run: Optional[int] = None,
                        chain: int = 0) -> StateDict:
        """(Re-)initialise ``module`` (the sampler's by default) in place
        with the JAX package's initialisers, from a fresh sub-seed or from
        ``run`` (chain c > 0 on its own stream of it); returns its state
        dict (views, not copies)."""
        module = self.module if module is None else module
        run = self.next_seed() if run is None else run
        init_variables(module, make_generator("cpu", run, "init", *((chain,) if chain else ())))
        return module.state_dict()

    def compute_val_loss(self, val_split, state: Optional[StateDict] = None) -> float:
        """Mean cross entropy over ``val_split`` in eval mode, of ``state``
        or, by default, of chain 0's current weights, through one
        ``make_eval_loss_fn`` program a split, kept with the split."""
        if state is None:
            state = self._single_member()
        entry = self._val_loss_programs.get(id(val_split))
        if entry is None or entry[0] is not val_split:
            entry = self._val_loss_programs[id(val_split)] = (
                val_split, make_eval_loss_fn(self.module, val_split))
        return float(entry[1](state))

    def _single_member(self) -> StateDict:
        raise NotImplementedError

    def _ensemble_from_draws(self, draws) -> Ensemble:
        """S draws -> an ensemble of S * chains members, draw-major (the
        JAX package's (S, chains) -> (S * chains) merge); on a mesh this
        rank holds its chains' S * chains / chain of them."""
        state = stack_state_dicts(draws)
        if self.chains > 1:
            state = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in state.items()}
        return Ensemble(self.module, state, len(draws) * self.chains, mesh=self.mesh,
                        chains=self.chains, replicated=self.replicated)

    # -- mid-chain checkpoints ---------------------------------------------------

    def enable_auto_checkpoint(self, path: str, every_epochs: int = 10,
                               resume: bool = True) -> bool:
        """Save the chain to ``path`` every ``every_epochs`` epochs (draws,
        for HMC and the PCA subspace sampler); with ``resume``, restore an
        existing checkpoint there. Returns True if one was restored. On a
        mesh every rank calls it with the same path, which every rank reads
        and rank 0 writes."""
        self._ckpt_path = path
        self._ckpt_every = max(1, int(every_epochs))
        if self.mesh is not None:  # no rank looks before every rank is here
            self.mesh.barrier()
        if resume and os.path.exists(path):
            self._restore_checkpoint(path)
            return True
        return False

    def _checkpoint_due(self, count: int) -> bool:
        return self._ckpt_path is not None and count % self._ckpt_every == 0

    def _restore_checkpoint(self, path: str) -> None:
        raise NotImplementedError

    def _chain_generators(self) -> Dict[str, list]:
        """This rank's per-chain generators by kind, in ``chain_ids`` order:
        chain c's is checkpointed as ``<kind><c>``."""
        return {}

    def _shared_generators(self) -> Dict[str, torch.Generator]:
        """The generators every chain (and every rank) shares, by name."""
        return {}

    def _generators(self) -> Dict[str, torch.Generator]:
        """Every generator this rank draws from, by a stable name."""
        gens = dict(self._shared_generators())
        for kind, rows in self._chain_generators().items():
            gens.update({f"{kind}{c}": g for c, g in zip(self.chain_ids, rows)})
        return gens


class _EpochSampler(_Inference):
    """C chains (``self.modules``), each with its own module and so its own
    BatchNorm buffers, batch plans, crops and flips (``self._data_gens``)
    and dropout streams (``self._dropout_gens``); their parameters, momenta
    and gradients are the rows of one (C, P) buffer each (``self._state``).
    Hyperparameters live in 0-dim device tensors (``self._hyp``, keys
    ``_HYP_KEYS``) that ``_setup`` fills in place, so changing them rebuilds
    nothing; the Langevin noise gate is one more (``self._noise_gate``). A
    sweep (``inference/vectorized.py``) makes the chains its configurations,
    with (C,) hyperparameter tensors and each row's generators.

    A train split with ``epoch`` (``data.native.HostStreamingSplit``) stays
    on the host: each epoch streams its batches, one chain only, and the
    split's permutation takes the place of the data generator's (which
    still draws the crops and flips). On a data mesh the split streams this
    rank's rows of every batch: it must have been made with the sampler's
    mesh (ValueError otherwise).

    On a mesh ``self.modules`` are this rank's chains (``chain_ids``) and
    ``self.chains`` counts every rank's; the epoch is the sharded one of
    ``engine.train_steps`` (or ``stream_steps``).

    ``step_program`` is ``"graph"``: every epoch runs through
    ``engine.make_epoch_fn``'s program, resident or streamed, with or
    without dropout, off a mesh or on any mesh (its step captured once as
    a CUDA graph on the card and replayed, a model with dropout drawing its
    masks into static buffers before each replay, a data mesh's step cut
    at its all-reduces, which run between two replays; run eagerly on the
    CPU). ``train_steps`` and ``stream_steps`` are its plain versions, run
    only where ``epoch_program`` is hidden (an eager twin). The program is
    built at the first epoch and again only when ``_state`` or ``_hyp`` is
    a new object (a sweep's) or the split's batches no longer fit it (a
    stream of another transfer layout); update_hyp, the noise gate, a
    second ``sample()``, a checkpoint restore and a stream of the same
    layout in place of the split keep it. The full-batch samplers, which
    run no epochs, follow the same rule for their potentials: HMC's and
    the PCA subspace sampler's CE sums, gradients and log densities run
    through ``engine.make_potential_fn``'s programs, on a mesh followed by
    their one all-reduce over 'data'."""

    _HYP_KEYS: tuple = ()
    _LR_FN = None  # (hyp, epoch, batch_idx, step) -> lr
    _UPDATE_FN = None  # (state, hyp, *, lr, noise_on, is_first_step, seed)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        self._streamed = hasattr(train, "epoch")
        if not self._streamed:
            self._images, self._labels = train.device_tensors(self.device)
        elif self.chains > 1:
            raise ValueError(f"host-streaming epochs are single-chain: chains={self.chains}")
        else:
            layout = (0, 1) if self.mesh is None else (self.mesh.data_idx,
                                                       self.mesh.shape["data"])
            if getattr(train, "data_layout", (0, 1)) != layout:
                raise ValueError(f"the stream's data layout {train.data_layout} (data_idx, "
                                 f"data) is not the sampler's mesh's {layout}: make the "
                                 "HostStreamingSplit with the same mesh")
            self._images = self._labels = None
        self.modules = [self.module] + [copy.deepcopy(self.module)
                                        for _ in range(len(self.chain_ids) - 1)]
        params, grads = flatten_chains(self.modules)
        self._state = TrainState(self.module, params, torch.zeros_like(params), grads,
                                 modules=self.modules, row_offset=self.chain_ids[0],
                                 total_rows=self.chains)
        self._hyp = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                     for k in self._HYP_KEYS}
        self._noise_gate = torch.ones((), dtype=torch.float32, device=self.device)
        self._has_dropout = bool(dropout_layers(self.module))
        self._program = None  # engine.make_epoch_fn's program, built at the first epoch
        self.epoch_losses: list = []  # mean training loss per epoch, on the device

    def _fill_hyp(self, values: dict) -> None:
        for k, v in values.items():
            self._hyp[k].fill_(v)

    def _init_state(self):
        """Fresh weights, zero momentum, step 0, and fresh generators."""
        run = self.next_seed()
        for c, module in zip(self.chain_ids, self.modules):
            self.fresh_variables(module, run, c)
        self._state.momentum.zero_()
        self._state.grads.zero_()
        self._state.step = 0
        self.epochs_run = 0
        self.burnt_in = False
        # permutations and crop/flip choices are drawn on the device; the
        # per-step noise seeds and per-epoch dropout seeds on the host
        self._data_gens = [make_generator(self.device, run, "data", *((c,) if c else ()))
                           for c in self.chain_ids]
        self._noise_gen = self._noise_generator(run)
        # (generator, rows): the chains' dropout seeds, drawn in row order for
        # every chain; this rank keeps ``_dropout_rows`` of them
        self._dropout_gens = [(torch.Generator().manual_seed(derive_seed(run, "dropout")),
                               self.chains)]
        self._dropout_rows = slice(self.chain_ids[0], self.chain_ids[-1] + 1)

    @staticmethod
    def _noise_generator(run: int) -> torch.Generator:
        """The host generator of the steps' noise seeds of run ``run``."""
        return torch.Generator().manual_seed(derive_seed(run, "noise"))

    def epoch_program(self):
        """The ``engine.make_epoch_fn`` program of the epochs, resident or
        streamed, on the sampler's mesh, built on first use and rebuilt when
        ``_state``, ``_hyp`` or the chain strategy is a new one, or the
        split no longer fits it."""
        prog, split = self._program, self.train
        if (prog is None or prog.state is not self._state or prog.hyp is not self._hyp
                or prog.chain_strategy != self._resolved_chain_strategy
                or not prog.fits(split)):
            self._program = make_epoch_fn(
                self._state, split, self._images, self._labels, hyp=self._hyp,
                noise_on=self._noise_gate, lr_fn=self._LR_FN, update_fn=self._UPDATE_FN,
                chain_strategy=self._resolved_chain_strategy, mesh=self.mesh)
        return self._program

    def _run_epoch(self, noise_on: Optional[bool] = None) -> torch.Tensor:
        """One epoch on every chain; ``noise_on`` sets the noise gate first
        (None keeps it). Counted in ``tracing``'s ``sampler.epoch`` from
        before its draws to its program's return."""
        with tracing.span("sampler.epoch"):
            start = tracing.epoch_start(self.device)
            if noise_on is not None:
                self._noise_gate.fill_(1.0 if noise_on else 0.0)
            split = self.train
            with tracing.span("sampler.draws"):
                idx, aug, seeds, dropout_seeds = self._epoch_draws()
            program = self.epoch_program()  # None only where a test hides it: the plain path
            if program is not None:
                loss = program(split if self._streamed else idx, epoch=self.epochs_run,
                               seeds=seeds, aug=aug, dropout_seeds=dropout_seeds)
            else:
                kw = dict(epoch=self.epochs_run, noise_on=self._noise_gate, hyp=self._hyp,
                          lr_fn=self._LR_FN, update_fn=self._UPDATE_FN, seeds=seeds.tolist(),
                          aug=aug, dropout_seeds=dropout_seeds, mesh=self.mesh)
                if self._streamed:
                    loss = stream_steps(self._state, split, **kw)
                else:
                    loss = train_steps(self._state, self._images, self._labels, idx,
                                       spec=split.spec,
                                       chain_strategy=self._resolved_chain_strategy, **kw)
            tracing.epoch_end(start)
        self.epochs_run += 1
        self.epoch_losses.append(loss)
        return loss

    def _epoch_draws(self) -> tuple:
        """An epoch's host draws: the batch plan (None for a streamed
        epoch), the crops and flips, the steps' noise seeds and the chains'
        dropout seeds."""
        split = self.train
        idx = None
        if self._streamed:  # one chain: a streamed epoch refuses a sweep's K rows
            shape = (1, split.num_batches, split.batch_size)
        else:
            idx = torch.stack([epoch_indices(g, split.n, split.batch_size)
                               for g in self._data_gens])
            shape = tuple(idx.shape)
        aug = None
        if split.spec.augments:
            draws = [draw_augment(g, shape[1:], split.spec) for g in self._data_gens]
            aug = tuple(None if draws[0][j] is None else torch.stack([d[j] for d in draws])
                        for j in range(3))
        seeds = torch.randint(0, 2 ** 63 - 1, (shape[1],), generator=self._noise_gen)
        dropout_seeds = ([s for gen, rows in self._dropout_gens
                          for s in torch.randint(0, 2 ** 63 - 1, (rows,), generator=gen).tolist()
                          ][self._dropout_rows] if self._has_dropout else None)
        return idx, aug, seeds, dropout_seeds

    def _log_val_loss(self, loss, val_loader, debug_val_loss: bool) -> None:
        if debug_val_loss and val_loader is not None:
            print({"train_loss": float(loss.mean()),
                   "val_loss": self.compute_val_loss(val_loader)})

    def _harvest(self) -> StateDict:
        """A copy of every chain's parameters and BatchNorm buffers (this
        rank's, on a mesh), with a leading chain axis when the sampler has
        more than one chain."""
        states = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                  for m in self.modules]
        return states[0] if self.chains == 1 else stack_state_dicts(states)

    def _single_member(self) -> StateDict:
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def _dropout_shared(self) -> bool:
        """Whether one dropout generator draws every chain's seeds (a
        sweep's rows keep one each)."""
        return len(self._dropout_gens) == 1 and self._dropout_gens[0][1] == self.chains

    def _chain_generators(self) -> Dict[str, list]:
        gens = {"data": list(self._data_gens)}
        if not self._dropout_shared():
            gens["dropout"] = [g for g, _ in self._dropout_gens]
        return gens

    def _shared_generators(self) -> Dict[str, torch.Generator]:
        gens = {"noise": self._noise_gen}
        if self._dropout_shared():
            gens["dropout0"] = self._dropout_gens[0][0]
        return gens

    def _maybe_checkpoint(self) -> None:
        if self._checkpoint_due(self.epochs_run):
            from ..utils_checkpoint import save_sampler_state

            save_sampler_state(self._ckpt_path, self)

    def _restore_checkpoint(self, path: str) -> None:
        from ..utils_checkpoint import restore_sampler_state

        restore_sampler_state(path, self)
